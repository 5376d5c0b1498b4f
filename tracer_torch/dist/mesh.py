"""The render mesh and process-group bootstrap (torch counterpart of
tracer/dist/mesh.py).

SPMD, one process a rank. The mesh is a torch DeviceMesh over the whole
world with dims ("data", "geom"): rays and image rows are split over
"data", scene geometry over "geom" (dist/ring.py). Its layout is row-major,
as the reference's devices.reshape(data, geom): the rank at (i, j) is
global rank i * geom + j.

The backend follows the device the caller names: NCCL for CUDA tensors,
gloo for CPU tensors. A CUDA mesh over a group that is not NCCL raises;
nothing falls back to gloo on the card.

spawn_world runs a function on k ranks of a fresh world (processes forked
from multiprocessing's fork server, a file:// store, a timeout on the group
and on the wait), for scaling.scaling_sweep and the tests; stop_fork_server,
which also runs at exit, stops the processes it leaves for the next world.
The reference needs none: JAX is single-controller.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import pickle
import tempfile
import threading
import time
from multiprocessing import forkserver, resource_tracker

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.multiprocessing.spawn import ProcessException

DATA_AXIS = "data"
GEOM_AXIS = "geom"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process-group backend of a device: nccl for cuda, gloo for cpu."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no distributed backend for device type {kind!r}")
    return BACKENDS[kind]


def _check_backend(device):
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call init_process_group "
                           "(or init_multihost, or run under spawn_world) first")
    want, have = backend_for(device), dist.get_backend()
    if have != want:
        raise RuntimeError(f"a {torch.device(device).type} mesh needs the {want} backend, "
                           f"the world runs {have}")


def make_render_mesh(data: int | None = None, geom: int = 1, device="cuda") -> DeviceMesh:
    """The render mesh over the current world: dims ("data", "geom"),
    row-major (global rank = i * geom + j). Defaults: every rank on the data
    axis. data * geom must equal the world size. Every rank must call it:
    it creates the mesh's process groups."""
    _check_backend(device)
    n = dist.get_world_size()
    if data is None:
        data = n // geom
    if data * geom != n:
        raise ValueError(f"data({data}) * geom({geom}) != world size({n})")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(data, geom),
                      mesh_dim_names=(DATA_AXIS, GEOM_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of the mesh live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def init_multihost(coordinator: str, num_processes: int, process_id: int, device="cuda",
                   timeout: float = 60.0) -> None:
    """Multi-host bootstrap (one process a host or a card): joins the world
    of num_processes ranks whose rank 0 listens on `coordinator`
    ("host:port"), over the backend of `device`. On CUDA the rank's card
    is its local rank (LOCAL_RANK, as torchrun sets it, else process_id
    modulo the visible cards)."""
    backend = backend_for(device)
    card = None
    if backend == "nccl":
        card = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout), device_id=card)


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------

def _rank_main(rank, world, tmp, device, timeout, fn, args):
    torch.set_num_threads(1)
    backend = backend_for(device)
    card = None
    if backend == "nccl":
        card = torch.device("cuda", rank)
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout),
                            device_id=card)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _failures(ctx) -> list[str]:
    """Each failed rank of a joined ProcessContext: its traceback, else its
    exit code."""
    out = []
    for r, p in enumerate(ctx.processes):
        if p.exitcode == 0:
            continue
        if os.path.exists(ctx.error_files[r]):
            with open(ctx.error_files[r], "rb") as f:
                out.append(f"rank {r}: {pickle.load(f)}")
            os.unlink(ctx.error_files[r])
        else:
            out.append(f"rank {r}: exited with code {p.exitcode}")
    return out


_helpers_lock = threading.Lock()
_started: list = []     # the helper processes spawn_world started and has not stopped


def _fork_server():
    """The ranks fork from multiprocessing's fork server, which imports torch
    and this package once (nothing there touches a card or starts a thread):
    a spawned interpreter would take seconds of CPU a rank to import torch.
    The server, and the resource tracker it starts, serve every later world
    of this process until stop_fork_server."""
    fs, rt = forkserver._forkserver, resource_tracker._resource_tracker
    with _helpers_lock:
        multiprocessing.set_forkserver_preload(["torch", "tracer_torch.dist"])
        _started.extend(h for h, pid in ((fs, fs._forkserver_pid), (rt, rt._pid))
                        if pid is None and h not in _started)


@atexit.register
def stop_fork_server() -> None:
    """Stop the fork server and the resource tracker that spawn_world
    started, and wait for them; the next world starts them anew. Call it
    when no world runs. It runs at exit as well, so that no process of
    spawn_world outlives the interpreter. (multiprocessing has no public
    way to stop them: _stop is private, and unchanged since Python 3.8.)"""
    with _helpers_lock:
        for h in _started:
            h._stop()
        _started.clear()


def spawn_world(fn, world_size: int, *args, device="cuda", timeout: float = 60.0,
                join_timeout: float = 600.0) -> list:
    """Run fn(rank, *args) on each rank of a new world of `world_size`
    processes -> [result of rank 0, rank 1, ...].

    Each rank sets torch to one thread, joins the world through a file://
    store in a temporary directory over the backend of `device` (on CUDA,
    rank r on card r) with `timeout` seconds on every collective, runs fn,
    and leaves. fn and its arguments are pickled (fn must be importable by
    name) and so is its result. A rank that raises or dies fails the call:
    torch.multiprocessing's ProcessContext stops the others, and the
    RuntimeError here lists each failed rank's traceback or exit code, as
    it says when the world outlasts `join_timeout` seconds. The fork server
    the ranks fork from stays for the next world, until stop_fork_server or
    the interpreter's exit."""
    name = getattr(fn, "__name__", fn)
    _fork_server()
    with tempfile.TemporaryDirectory(prefix="tracer_world_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world_size, tmp, device, timeout, fn, args), nprocs=world_size,
            join=False, daemon=True, start_method="forkserver")
        deadline = time.monotonic() + join_timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0), grace_period=2.0):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"spawn_world({name}): the world of {world_size} "
                                       f"outlasted {join_timeout} s")
        except ProcessException as e:
            raise RuntimeError(f"spawn_world({name}) failed:\n" + "\n".join(_failures(ctx))) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
