"""tracer_torch.dist.mesh on the CPU: make_render_mesh in a world of 8 gloo
ranks maps rank (i, j) to the device at (i, j) of the reference's
Mesh(devices.reshape(data, geom)) over the 8 virtual devices, with the same
data groups (a column) and geom groups (a row), for (data, geom) = (8, 1),
(4, 2), (2, 4) and (1, 8); it refuses a shape that does not fit the world
and a CUDA mesh over gloo. spawn_world fails, and does not hang, when a rank
dies or raises while another waits in a collective, and stop_fork_server
stops the helper processes its worlds leave. Two OS processes join
one world through init_multihost (tcp://) and each holds its band of the
row-split cornell frame to the reference's single-device render, as
tests/dist/test_multihost.py does."""
import importlib
import inspect
import os
import socket
import subprocess
import sys
import time
from functools import partial
from multiprocessing import forkserver
from pathlib import Path

import jax
import numpy as np
import pytest

from tracer.api import get_scene as j_get_scene
from tracer.dist.mesh import make_render_mesh as j_make_render_mesh
from tracer.render.whitted import WhittedConfig as JWhittedConfig, render_image
from tracer.utils.config import load_config as j_load_config
import tracer.dist as jdist
import tracer_torch.dist as tdist
from tracer_torch.dist import mesh
from tracer_torch.dist.mesh import backend_for, spawn_world, stop_fork_server

import dist_workers

ROOT = Path(__file__).resolve().parents[2]
LAYOUTS = ((8, 1), (4, 2), (2, 4), (1, 8))
CONSTANTS = {"mesh": ("DATA_AXIS", "GEOM_AXIS"), "ring": ("ROW_COLS", "_RING_K_CAP", "_RING_TR")}


@pytest.mark.parametrize("module", ["mesh", "ulysses", "ray_dp", "grad_overlap", "ring",
                                    "scaling"])
def test_every_public_function_is_ported(module):
    """Each public function of tracer/dist/<module>.py (and its upper-case
    constants) has a namesake in tracer_torch/dist/<module>.py; the package
    exports what the reference's exports."""
    ref = importlib.import_module(f"tracer.dist.{module}")
    port = importlib.import_module(f"tracer_torch.dist.{module}")
    names = [k for k, v in vars(ref).items() if not k.startswith("_")
             and inspect.isfunction(v) and v.__module__ == ref.__name__]
    assert names
    assert not [k for k in names if not callable(getattr(port, k, None))]
    for k in CONSTANTS.get(module, ()):
        assert getattr(port, k) == getattr(ref, k), k
    assert tdist.__all__ == jdist.__all__


@pytest.fixture(scope="module")
def world():
    return spawn_world(dist_workers.mesh_world, 8, LAYOUTS, device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS, ids=["8x1", "4x2", "2x4", "1x8"])
def test_mesh_layout_matches_reference(layout, world):
    ids = np.vectorize(lambda d: d.id)(j_make_render_mesh(jax.devices(), *layout).devices)
    assert ids.shape == layout
    for rank, res in enumerate(world):
        i, j, data_ranks, geom_ranks = res[layout]
        assert ids[i, j] == rank
        assert data_ranks == ids[:, j].tolist()
        assert geom_ranks == ids[i, :].tolist()


def test_mesh_refusals(world):
    for res in world:
        assert res["misfit"].startswith("ValueError: data(3) * geom(3) != world size(8)")
        assert res["cuda"].startswith("RuntimeError: a cuda mesh needs the nccl backend")
    assert backend_for("cuda") == "nccl" and backend_for("cpu") == "gloo"


@pytest.mark.parametrize("how,message", [("exit", "rank 1: exited with code 3"),
                                         ("raise", "rank 1 raised on purpose")])
def test_spawn_world_fails_when_a_rank_fails(how, message):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=message):
        spawn_world(dist_workers.dying_world, 2, how, device="cpu", timeout=30.0,
                    join_timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def _running(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_stop_fork_server_leaves_no_process_behind(world):
    """The fork server a world forked from, and the resource tracker it
    started, are running after the world; stop_fork_server (which also
    runs at exit) stops them and waits for them."""
    fs = forkserver._forkserver
    assert fs in mesh._started
    pids = [h._forkserver_pid if h is fs else h._pid for h in mesh._started]
    assert pids and all(pid is not None and _running(pid) for pid in pids)
    stop_fork_server()
    assert not mesh._started and fs._forkserver_pid is None
    assert not [pid for pid in pids if _running(pid)]


_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["TRACER_ROOT"])
import numpy as np
import torch
import torch.distributed as dist
from tracer_torch.api import get_scene
from tracer_torch.dist.mesh import init_multihost, make_render_mesh
from tracer_torch.dist.ray_dp import band_rows, make_sharded_render_fn
from tracer_torch.utils.config import load_config

pid = int(sys.argv[1])
torch.set_num_threads(1)
init_multihost(os.environ["COORD"], 2, pid, device="cpu", timeout=30.0)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
cfg = load_config("cornell256", height=32, width=32)
scene, cam = get_scene(cfg, "cpu")
img = make_sharded_render_fn(scene, cfg, make_render_mesh(data=2, device="cpu"))(scene, cam)
y0, rows = band_rows(cfg.height, 2, pid)
got = img.numpy()[y0:y0 + rows]
want = np.load(os.environ["REF"])[y0:y0 + rows]
mism = np.mean(~np.isclose(got, want, rtol=1e-4, atol=1e-4))
assert mism < 0.05, f"proc {pid}: {mism:.2%} differ"
p90 = np.percentile(np.abs(got - want).max(axis=-1), 90)
assert p90 < 1e-5, f"proc {pid}: p90 err {p90:.2e}"
dist.destroy_process_group()
print(f"MULTIHOST_PASS {pid}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_init_multihost(tmp_path):
    cfg = j_load_config("cornell256", height=32, width=32)
    scene, cam = j_get_scene(cfg)
    # Compiled: eagerly the reference's frame takes seconds of op compiles.
    ref = np.asarray(jax.jit(partial(
        render_image, height=cfg.height, width=cfg.width,
        cfg=JWhittedConfig(max_bounces=cfg.max_bounces,
                           smooth_shading=cfg.smooth_shading)))(scene, cam))
    np.save(tmp_path / "ref.npy", ref)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(COORD=f"127.0.0.1:{_free_port()}", TRACER_ROOT=str(ROOT),
               REF=str(tmp_path / "ref.npy"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(pid)], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for pid in (0, 1):
        assert f"MULTIHOST_PASS {pid}" in outs[pid]
