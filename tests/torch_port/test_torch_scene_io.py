"""tracer_torch.scene.io (OBJ + MTL) and the obj:<path> scene, against the
JAX package's tracer.scene.io and tracer.api.get_scene on the same files
(the counterpart of tests/unit/test_scene_io.py). Loaded arrays and the
obj: scene's camera are held equal to the reference's; the native parser
(cpp/objloader.cpp, through the port's own binding) equal to the Python
one, where g++ builds it."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tracer import api as japi
from tracer.scene.io import load_obj as j_load_obj
from tracer.utils.config import load_config as j_load_config
from tracer_torch import api
from tracer_torch.scene import cpp_loader
from tracer_torch.scene.io import load_obj, save_obj
from tracer_torch.utils.config import load_config
from tracer_torch.utils.image import read_png

from parity_util import leaves

ROOT = Path(__file__).resolve().parents[2]
OBJ = """\
# tiny test scene
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
usemtl red
f 1 2 3 4
v 0 0 1
v 1 0 1
v 1 1 1
usemtl glow
f -3 -2 -1
"""
MTL = """\
newmtl red
Kd 0.8 0.1 0.1
newmtl glow
Kd 0.2 0.2 0.2
Ke 3.0 2.0 1.0
Ks 0.5 0.5 0.5
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    return str(tmp_path / "test.obj")


def need_native():
    if not cpp_loader.available():
        pytest.skip(f"the native OBJ parser did not build (g++): {cpp_loader._load()[1]}")


def _fields(scene) -> dict:
    """A port Scene's tensors as {field: numpy}, nested as leaves() nests."""
    out = {}
    for k in ("verts", "tris", "mat_id", "normals"):
        out[k] = getattr(scene, k).numpy()
    out["materials"] = {k: getattr(scene.materials, k).numpy() for k in
                        ("albedo", "emission", "mirror", "specular", "shininess")}
    out["lights"] = {k: getattr(scene.lights, k).numpy() for k in ("position", "intensity")}
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("native", [False, "auto"])
@pytest.mark.parametrize("default_light", [True, False])
def test_load_obj_matches_reference(tmp_path, native, default_light):
    """Geometry, fan triangulation, negative indices, materials and the
    default light, array for array."""
    path = _write(tmp_path)
    got = load_obj(path, default_light=default_light, native=native, device="cpu")
    want = j_load_obj(path, default_light=default_light, native=False)
    assert got.num_tris == 3 and got.verts.device.type == "cpu"
    _assert_same(_fields(got), leaves(want))


def test_native_matches_python(tmp_path):
    need_native()
    path = _write(tmp_path)
    _assert_same(_fields(load_obj(path, native=True, device="cpu")),
                 _fields(load_obj(path, native=False, device="cpu")))


def test_save_load_roundtrip(tmp_path):
    """save_obj takes tensors or arrays; a reload gives the same geometry
    through both parsers, at a size past the tiny scene."""
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(500, 3)).astype(np.float32)
    tris = rng.integers(0, 500, size=(900, 3)).astype(np.int32)
    path = str(tmp_path / "big.obj")
    save_obj(path, torch.from_numpy(verts), torch.from_numpy(tris))
    s_py = load_obj(path, native=False, device="cpu")
    np.testing.assert_array_equal(s_py.tris.numpy(), tris)
    np.testing.assert_allclose(s_py.verts.numpy(), verts, rtol=1e-6)
    path2 = str(tmp_path / "again.obj")
    save_obj(path2, verts, tris)
    assert Path(path).read_text() == Path(path2).read_text()
    need_native()
    _assert_same(_fields(load_obj(path, native=True, device="cpu")), _fields(s_py))


def test_multi_mtllib_line(tmp_path):
    """Several library files on one mtllib line load through both parsers."""
    (tmp_path / "a.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\n")
    (tmp_path / "b.mtl").write_text("newmtl glow\nKd 0.2 0.2 0.2\nKe 3 2 1\n")
    (tmp_path / "m.obj").write_text("mtllib a.mtl b.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                    "usemtl red\nf 1 2 3\nusemtl glow\nf 1 3 4\n")
    path = str(tmp_path / "m.obj")
    s_py = load_obj(path, native=False, device="cpu")
    mat = s_py.mat_id.numpy()
    np.testing.assert_allclose(s_py.materials.albedo.numpy()[mat[0]], [0.8, 0.1, 0.1])
    np.testing.assert_allclose(s_py.materials.emission.numpy()[mat[1]], [3.0, 2.0, 1.0])
    _assert_same(_fields(s_py), leaves(j_load_obj(path, native=False)))
    need_native()
    _assert_same(_fields(load_obj(path, native=True, device="cpu")), _fields(s_py))


def test_native_true_raises_when_unavailable(tmp_path, monkeypatch):
    """native=True requires the C++ parser; "auto" falls back to Python."""
    path = _write(tmp_path)
    monkeypatch.setattr(cpp_loader, "_load", lambda: (None, "no compiler"))
    with pytest.raises(cpp_loader.LoaderUnavailable, match="no compiler"):
        load_obj(path, native=True, device="cpu")
    assert load_obj(path, native="auto", device="cpu").num_tris == 3


def test_obj_scene_through_get_scene_and_render(tmp_path):
    """obj:<path> through get_scene: the reference's scene arrays and its
    camera (the bounding box's centre, from (0, 0.3, 1.2) times the
    diagonal, fov 45), then a lit, finite frame from make_render_fn."""
    path = _write(tmp_path)
    cfg = load_config("cornell256", scene=f"obj:{path}", height=16, width=16)
    scene, camera = api.get_scene(cfg, "cpu")
    j_scene, j_cam = japi.get_scene(j_load_config("cornell256", scene=f"obj:{path}"))
    _assert_same(_fields(scene), leaves(j_scene))
    for k, v in leaves(j_cam).items():
        np.testing.assert_array_equal(getattr(camera, k).numpy(), v, err_msg=k)
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)
    assert aux["overflow"] == 0 and img.shape == (16, 16, 3)
    assert torch.isfinite(img).all() and img.max() > 0.0


def test_trace_torch_renders_an_obj_scene(tmp_path):
    """bin/trace_torch --cpu --scene obj:<path> writes its PNG."""
    path = _write(tmp_path)
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({"scene": f"obj:{path}", "height": 16, "width": 16}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(ROOT / "bin" / "trace_torch"), "--preset",
                           str(cfg), "--cpu", "-o", "obj.png"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "overflow 0" in proc.stdout and "tris=3" in proc.stdout
    assert read_png(str(tmp_path / "obj.png")).shape == (16, 16, 3)
