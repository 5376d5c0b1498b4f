"""The grad step of tracer_torch against the JAX package's on the CPU.

Gradients are recovered from one SGD(1.0) step, g = params_before -
params_after, as tests/grad/test_tiled_grad.py does, on its fixture: the
frame-filling tessellated plane at 32x32 seen from tests/grad/test_edge.py's
CAM, fed to both packages through tracer_torch.bridge. The reference runs
its tiled tier in interpret mode (tiled="interpret") and its jnp tier
(tiled="off"); the port's tiled tier runs its kernels' plain versions on
CPU tensors. Gate: loss to rtol 1e-5, each gradient nonzero and to rtol
2e-3 + atol 2e-6 of its largest entry (the reference's own gate between its
two tiers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.grad.test_accel_grads import _tessellated_plane
from tests.grad.test_edge import CAM
from tracer import api as japi
from tracer.bvh import build_scene_accel as j_build_accel
from tracer.render.tiled import render_tiled as j_render_tiled
from tracer.render.whitted import WhittedConfig as JWhittedConfig
from tracer.scene import procedural as jproc
from tracer.scene.types import compute_vertex_normals_jnp
from tracer.scene.types import make_vertex_normal_fn as j_make_vertex_normal_fn
from tracer.utils.config import load_config as j_load_config
from tracer_torch import api
from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.bvh import cluster
from tracer_torch.core.types import T_FAR
from tracer_torch.kernels import traversal as tt
from tracer_torch.kernels import traversal2 as t2
from tracer_torch.render import tiled
from tracer_torch.scene.types import compute_vertex_normals_torch, make_vertex_normal_fn
from tracer_torch.utils.config import load_config

from parity_util import leaves

FIELDS = dict(height=32, width=32, use_pallas=True)
J_CFG = j_load_config("bunny-grad", **FIELDS)
CFG = load_config("bunny-grad", **FIELDS)
PARAMS = ("verts", "albedo", "cam_pos")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small CPU ops; with several test workers on the
    machine, torch's intra-op threads only contend. One thread here, the
    caller's setting restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_grads(cfg, tiled_mode, scene, camera, target, keys=PARAMS):
    """The reference's loss and gradients through one sgd(1.0) step."""
    p = {"verts": scene.verts, "albedo": jnp.asarray(scene.materials.albedo),
         "cam_pos": jnp.asarray(camera.position)}
    p = {k: p[k] for k in keys}
    opt = optax.sgd(1.0)
    step = japi.make_grad_step_fn(cfg, opt, tiled=tiled_mode)
    loss, new, _, aux = step(scene, camera, jnp.asarray(target), p, opt.init(p))
    assert int(aux["overflow"]) == 0
    return float(loss), {k: np.asarray(p[k]) - np.asarray(new[k]) for k in p}


def _t_grads(cfg, tiled_mode, scene, camera, target, keys=PARAMS):
    """The port's loss and gradients through one SGD(1.0) step."""
    p = api.grad_params(scene, camera, keys)
    before = {k: v.detach().clone() for k, v in p.items()}
    step = api.make_grad_step_fn(cfg, scene, camera, tiled_mode, device="cpu")
    loss, p, _, aux = step(scene, camera, torch.as_tensor(target), p,
                           torch.optim.SGD(p.values(), lr=1.0))
    assert aux == {"overflow": 0}
    return float(loss), {k: (before[k] - p[k].detach()).numpy() for k in p}


def _gate(got, want):
    """Loss to rtol 1e-5; each gradient nonzero, rtol 2e-3 + atol 2e-6 max."""
    (loss_a, g_a), (loss_b, g_b) = got, want
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-5, atol=1e-8)
    assert set(g_a) == set(g_b)
    for key in g_b:
        a, b = g_a[key], g_b[key]
        assert np.abs(b).max() > 0, f"{key}: reference gradient is zero"
        assert np.abs(a).max() > 0, f"{key}: port gradient is zero"
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-6 * np.abs(b).max() + 1e-10,
                                   err_msg=key)


@pytest.fixture(scope="module")
def plane():
    """The plane and CAM in both packages, a zeros target, and each tier's
    step of both packages, computed once."""
    j_scene = _tessellated_plane()
    scene = scene_from_arrays(leaves(j_scene), "cpu")
    camera = camera_from_arrays(leaves(CAM), "cpu")
    target = np.zeros((CFG.height, CFG.width, 3), np.float32)
    ref = {mode: _j_grads(J_CFG, mode, j_scene, CAM, target) for mode in ("interpret", "off")}
    port = {mode: _t_grads(CFG, mode, scene, camera, target) for mode in ("interpret", "off")}
    return dict(scene=scene, camera=camera, target=target, ref=ref, port=port)


# ---------------------------------------------------------------------------
# Vertex normals that follow the vertices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scatter", "gather"])
def test_vertex_normals_match_reference(kind):
    """compute_vertex_normals_torch (scatter) and make_vertex_normal_fn
    (gather) against compute_vertex_normals_jnp / the reference's
    make_vertex_normal_fn on the subdiv-2 bunny: values to rtol 1e-6, and
    the VJP of a seeded random cotangent to rtol 1e-5."""
    j_scene, _ = jproc.bunny_scene(2)
    verts, tris = np.array(j_scene.verts), np.array(j_scene.tris)
    cot = np.random.default_rng(3).normal(size=verts.shape).astype(np.float32)
    if kind == "scatter":
        j_fn = lambda v: compute_vertex_normals_jnp(v, jnp.asarray(tris))
        t_fn = lambda v: compute_vertex_normals_torch(v, torch.as_tensor(tris))
    else:
        j_fn = j_make_vertex_normal_fn(tris, len(verts))
        t_fn = make_vertex_normal_fn(tris, len(verts), device="cpu")
    want, vjp = jax.vjp(j_fn, jnp.asarray(verts))
    (want_g,) = vjp(jnp.asarray(cot))
    v = torch.as_tensor(verts).requires_grad_(True)
    got = t_fn(v)
    (got_g,) = torch.autograd.grad(got, v, torch.as_tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5 * np.abs(want_g).max())
    # Both port versions give the numpy load-time normals.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(j_scene.normals),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The step against the reference, and its two tiers against each other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_grad_step_matches_reference(plane, mode):
    """The port's tiled="interpret" step against the reference's (its
    kernels' plain versions against interpret-mode Pallas), and the port's
    jnp tier (tiled="off") against the reference's, for verts, albedo and
    cam_pos."""
    _gate(plane["port"][mode], plane["ref"][mode])


def test_grad_step_tiers_agree(plane):
    """The port's tiled tier against its jnp tier, the reference's own test
    (tests/grad/test_tiled_grad.py:test_tiled_grad_step_matches_jnp_tier)."""
    _gate(plane["port"]["interpret"], plane["port"]["off"])


@pytest.fixture(scope="module")
def bunny24():
    """bunny-grad at subdiv 2 and 24x24 in both packages, and a real target:
    the reference's tiled frame + 0.05 (a zeros target cannot catch a
    mis-indexed target)."""
    fields = dict(height=24, width=24, scene_arg=2, use_pallas=True)
    j_cfg, cfg = j_load_config("bunny-grad", **fields), load_config("bunny-grad", **fields)
    j_scene, j_cam = japi.get_scene(j_cfg)
    wide = 1 << 20  # caps the reference clamps to the cluster counts: exact
    frame = np.asarray(jax.jit(lambda s, c: j_render_tiled(
        s, j_build_accel(s), c, 24, 24, JWhittedConfig(max_bounces=1), interpret=True,
        k_closest=wide, k_cap=wide, s_cap=wide))(j_scene, j_cam))
    assert frame.max() > 0.05, "the target must be lit"
    return dict(j_cfg=j_cfg, cfg=cfg, j_scene=j_scene, j_cam=j_cam, frame=frame,
                scene=scene_from_arrays(leaves(j_scene), "cpu"),
                camera=camera_from_arrays(leaves(j_cam), "cpu"))


@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_grad_step_real_target(bunny24, mode):
    """The port's step against the reference's with the real target. The
    loss is held to the float64 mean of (reference frame - target)**2, not
    to the reference step's loss: the residual is 0.05 almost everywhere,
    and the reference's float32 sum of it lands 1.7e-5 (relative) away
    from its own frame's exact loss, the port's within 1e-6."""
    b = bunny24
    target = b["frame"] + np.float32(0.05)
    loss, grads = _t_grads(b["cfg"], mode, b["scene"], b["camera"], target)
    _, want = _j_grads(b["j_cfg"], mode, b["j_scene"], b["j_cam"], target)
    exact = np.mean((b["frame"].astype(np.float64) - target) ** 2)
    _gate((loss, grads), (exact, want))


def test_tiled_loss_verts_fd(plane):
    """Central finite difference of the tiled loss in a y-offset of the
    frame-filling plane (interior motion only) against autograd, as
    tests/grad/test_tiled_grad.py:test_tiled_grad_step_verts_fd."""
    scene, camera = plane["scene"], plane["camera"]
    target = torch.as_tensor(plane["target"])
    wcfg = tiled.WhittedConfig(max_bounces=CFG.max_bounces, smooth_shading=CFG.smooth_shading)

    def loss(theta):
        s = dataclasses.replace(scene, verts=scene.verts + torch.stack(
            [torch.zeros(()), theta, torch.zeros(())]))
        img = tiled.render_tiled(s, cluster.build_scene_accel(s), camera, CFG.height,
                                 CFG.width, wcfg)
        return torch.mean((img - target) ** 2)

    theta = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    h = 2e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(h))) - float(loss(torch.tensor(-h)))) / (2 * h)
    assert abs(fd) > 1e-9
    assert abs(float(g) - fd) <= 0.05 * abs(fd) + 1e-7, f"AD {float(g)} vs FD {fd}"


# ---------------------------------------------------------------------------
# Routing, outputs, detached kernel inputs, bounded memory, the benchmark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, mode, overrides, want", [
    ("use_pallas", "auto", {"use_pallas": True}, "tiled"),
    ("bunny-grad", "auto", {}, "jnp"),
    ("past TILED_MAX_CLUSTERS", "auto", {"use_pallas": True}, "jnp"),
    ("interpret", "interpret", {}, "tiled"),
    ("off", "off", {"use_pallas": True}, "jnp"),
])
def test_auto_routing(monkeypatch, case, mode, overrides, want):
    """tiled="auto" takes the tiled tier where make_render_fn would (use_bvh
    and use_pallas, at most TILED_MAX_CLUSTERS clusters), the jnp tier
    otherwise; "interpret" and "off" force their tiers. The step that runs
    is observed, not the predicate alone."""
    if case == "past TILED_MAX_CLUSTERS":
        monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    cfg = load_config("bunny-grad", height=16, width=16, scene_arg=2, **overrides)
    scene, camera = api.get_scene(cfg, "cpu")
    ran = []
    for name, tier in (("render_tiled", "tiled"), ("render_wavefront", "jnp")):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _r=real, _t=tier, **k: ran.append(_t) or
                            _r(*a, **k))
    assert api.use_tiled_grad(scene, cfg, mode) == (want == "tiled")
    p = api.grad_params(scene, camera)
    api.make_grad_step_fn(cfg, scene, camera, mode, device="cpu")(
        scene, camera, torch.zeros(16, 16, 3), p, torch.optim.SGD(p.values(), lr=1.0))
    assert ran == [want]


@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_step_outputs(mode):
    """The four outputs: a detached 0-d loss, the params (the same leaves,
    updated in place), the optimizer, and {"overflow": 0}. grad_step
    returns the first three."""
    cfg = load_config("bunny-grad", height=16, width=16, scene_arg=2, use_pallas=True)
    scene, camera = api.get_scene(cfg, "cpu")
    p = api.grad_params(scene, camera, PARAMS)
    before = {k: v.detach().clone() for k, v in p.items()}
    opt = torch.optim.Adam(p.values(), lr=1e-3)
    out = api.make_grad_step_fn(cfg, scene, camera, mode, device="cpu")(
        scene, camera, torch.zeros(16, 16, 3), p, opt)
    assert len(out) == 4
    loss, p2, opt2, aux = out
    assert loss.shape == () and not loss.requires_grad and float(loss) > 0
    assert p2 is p and opt2 is opt and aux == {"overflow": 0}
    for k in PARAMS:
        assert p[k].is_leaf and p[k].requires_grad
        assert not torch.equal(p[k].detach(), before[k]), f"{k} did not move"
    # The scene the params were copied from is left alone.
    assert torch.equal(scene.verts, before["verts"])
    loss3, p3, opt3 = api.grad_step(scene, camera, torch.zeros(16, 16, 3), cfg, device="cpu")
    assert set(p3) == {"verts"} and isinstance(opt3, torch.optim.Adam)
    assert loss3.shape == () and float(loss3) > 0


@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_selection_sees_no_graph(monkeypatch, mode):
    """No cull and no kernel wrapper receives a tensor that requires grad;
    the gradients reach the params all the same (the graph exists)."""
    seen = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            flat = [x for a in list(args) + list(kwargs.values())
                    for x in ([getattr(a, f.name) for f in dataclasses.fields(a)]
                              if dataclasses.is_dataclass(a) else (a,))]
            seen.setdefault(name, []).append(
                any(isinstance(x, torch.Tensor) and x.requires_grad for x in flat))
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for module, name in ((tiled, "cull_clusters_sorted2"), (tiled, "trace_tiles_split"),
                         (tiled, "any_hit_tiles_graded"), (t2, "closest_hit"),
                         (t2, "closest_fast"), (t2, "anyhit"), (tt, "cull_clusters"),
                         (tt, "any_hit_tiles_plain"), (tt, "trace_tiles_plain")):
        spy(module, name)
    # The bunny's tiles all hold several clusters; the Cornell box is one
    # cluster, so its tiles go to closest_fast.
    for cfg in (load_config("bunny-grad", height=24, width=24, scene_arg=2, use_pallas=True),
                load_config("cornell256", height=16, width=16, use_bvh=True, use_pallas=True)):
        scene, camera = api.get_scene(cfg, "cpu")
        p = api.grad_params(scene, camera, PARAMS)
        api.make_grad_step_fn(cfg, scene, camera, mode, device="cpu")(
            scene, camera, torch.zeros(cfg.height, cfg.width, 3), p,
            torch.optim.SGD(p.values(), lr=1.0))
        for k in PARAMS:
            assert p[k].grad is not None and p[k].grad.abs().max() > 0, (cfg.scene, k)
    if mode == "interpret":
        selection = ("cull_clusters_sorted2", "trace_tiles_split", "any_hit_tiles_graded",
                     "closest_hit", "closest_fast", "anyhit")
    else:
        selection = ("cull_clusters", "any_hit_tiles_plain")
        # The plain tier's closest hit is what the gradients run through.
        assert all(seen["trace_tiles_plain"])
    for name in selection:
        assert seen.get(name), f"{name} never ran"
        assert not any(seen[name]), f"{name} received a tensor that requires grad"


N_TILES, TR, C = 4, 32, 16


def _saved_bytes(k: int, remat: bool, monkeypatch):
    """Bytes of the distinct storages autograd saves for backward in
    trace_tiles_plain over k candidate slots (all active), and the gradient
    of the hit distances w.r.t. tri_w and the ray origins. remat=False
    calls each slot's step directly instead of through the checkpoint."""
    monkeypatch.setattr(tt, "checkpoint", tt.checkpoint if remat
                        else (lambda fn, *a, **kw: fn(*a)))
    rng = np.random.default_rng(5)
    n_cl = 8
    tri_w = torch.as_tensor(rng.normal(size=(n_cl, 4, 3 * C)).astype(np.float32))
    tri_w.requires_grad_(True)
    tri_ids = torch.arange(n_cl * C, dtype=torch.int32).reshape(n_cl, C)
    accel = cluster.ClusterAccel(tri_w, tri_ids, *(torch.zeros(1, 3) for _ in range(4)),
                                 torch.zeros(1, 32))
    o = torch.as_tensor(rng.normal(size=(N_TILES, TR, 3)).astype(np.float32))
    o.requires_grad_(True)
    d = torch.as_tensor(rng.normal(size=(N_TILES, TR, 3)).astype(np.float32))
    cand = torch.as_tensor(rng.integers(0, n_cl, size=(N_TILES, k)).astype(np.int32))
    counts = torch.full((N_TILES,), k, dtype=torch.int32)
    saved = {}

    def pack(x):
        saved[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        bt = tt.trace_tiles_plain(o, d, accel, cand, counts)[0]
    loss = torch.where(bt < T_FAR, bt, 0.0).sum()
    g_w, g_o = torch.autograd.grad(loss, (tri_w, o))
    assert g_w.abs().max() > 0 and g_o.abs().max() > 0
    return sum(saved.values()), g_w, g_o


def test_plain_closest_memory_bounded(monkeypatch):
    """Under autograd the plain tier checkpoints each candidate slot. From 2
    to 8 candidates the bytes saved for backward grow only by what each
    slot's recompute starts from: its running best (bt, tri, u, v: 16 bytes
    a ray) and its cluster ids and active flags (9 bytes a tile), as the
    reference's checkpointed scan keeps its carry. Without the checkpoint
    each slot keeps at least its (TR, 3C) products (so and sd, 24 C bytes a
    ray), which is what overran the card at bunny512. The gradient is the
    one the step gives without the checkpoint, bit for bit."""
    with_2, _, _ = _saved_bytes(2, True, monkeypatch)
    with_8, g_w, g_o = _saved_bytes(8, True, monkeypatch)
    without_2, _, _ = _saved_bytes(2, False, monkeypatch)
    without_8, h_w, h_o = _saved_bytes(8, False, monkeypatch)
    n_rays = N_TILES * TR
    assert with_8 - with_2 <= 6 * (16 * n_rays + 9 * N_TILES)
    assert without_8 - without_2 >= 6 * 24 * C * n_rays
    torch.testing.assert_close(g_w, h_w, rtol=0, atol=0)
    torch.testing.assert_close(g_o, h_o, rtol=0, atol=0)


def test_benchmark_grad_step_keys():
    """benchmark_grad_step on the CPU returns its keys; its numbers describe
    the CPU and name it."""
    res = api.benchmark_grad_step(iters=1, warmup=1, params=PARAMS, device="cpu",
                                  height=16, width=16)
    assert set(res) == {"grad_step_ms", "loss", "overflow", "config", "device"}
    assert res["device"] == "cpu" and res["overflow"] == 0
    assert res["grad_step_ms"] > 0 and res["loss"] > 0
    assert (res["config"].height, res["config"].width) == (16, 16)
    with pytest.raises(ValueError, match="unknown parameter"):
        api.benchmark_grad_step(params=("lights",), device="cpu", height=16, width=16)
