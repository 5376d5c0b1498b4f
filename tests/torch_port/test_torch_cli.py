"""tracer_torch's utilities and command lines on the CPU: utils.image
(tonemap, write_png, read_png) against the JAX package's bytes,
utils.metrics (MetricsLogger's append and truncate, profile_trace),
api.benchmark's profile option, utils.config.DistConfig against the
reference's, and bin/fit_torch, bin/trace_torch and bin/bench_torch, each
run once with --cpu (the first two at 16x16 through a JSON config), and
without CUDA and without --cpu, where all three must refuse."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tracer.utils import image as jimage
from tracer.utils.config import DistConfig as JDistConfig
from tracer_torch import api
from tracer_torch.utils import image, metrics
from tracer_torch.utils.config import DistConfig, load_config

ROOT = Path(__file__).resolve().parents[2]


def test_png_bytes_match_reference(tmp_path):
    """tonemap's bytes and write_png's file are the reference's; read_png
    reads both packages' files back to the image."""
    rng = np.random.default_rng(0)
    hdr = rng.uniform(-0.5, 1.5, size=(17, 23, 3)).astype(np.float32)
    rgb8 = image.tonemap(hdr)
    np.testing.assert_array_equal(rgb8, jimage.tonemap(hdr))
    image.write_png(str(tmp_path / "port.png"), rgb8)
    jimage.write_png(str(tmp_path / "ref.png"), rgb8)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "ref.png").read_bytes()
    for name in ("port.png", "ref.png"):
        np.testing.assert_array_equal(image.read_png(str(tmp_path / name)), rgb8)
    np.testing.assert_array_equal(jimage.read_png(str(tmp_path / "port.png")), rgb8)


def test_tonemap_torch_matches_numpy():
    """The device tonemap gives tonemap's bytes (within one step of 255,
    where pow rounds differently), and clamps as it does."""
    hdr = np.random.default_rng(1).uniform(-0.5, 1.5, size=(64, 64, 3)).astype(np.float32)
    got = image.tonemap_torch(torch.as_tensor(hdr))
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int16) - image.tonemap(hdr).astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    x = torch.tensor([[[-1.0, 0.0, 0.5], [1.0, 2.0, 0.25]]])
    y = image.tonemap_torch(x)
    assert y[0, 0, 0] == 0 and y[0, 1, 0] == 255 and y[0, 1, 1] == 255


def test_metrics_logger_append_and_truncate(tmp_path):
    """One JSON line a record with its time; a new logger truncates the
    file, append=True keeps it; no path is a no-op."""
    path = str(tmp_path / "sub" / "m.jsonl")
    m = metrics.MetricsLogger(path)
    m.log(step=0, loss=1.5)
    m.log(step=1, loss=0.5, rays_per_s=1e6)
    lines = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in lines] == [0, 1] and lines[1]["rays_per_s"] == 1e6
    assert all("t" in r for r in lines)
    metrics.MetricsLogger(path, append=True).log(step=2)
    assert [json.loads(line)["step"] for line in open(path)] == [0, 1, 2]
    metrics.MetricsLogger(path)
    assert open(path).read() == ""
    metrics.MetricsLogger(None).log(step=0)
    assert metrics.is_host0()


def test_profile_trace(tmp_path):
    """Disabled: yields None and writes nothing; enabled: a Chrome trace in
    the directory."""
    with metrics.profile_trace(False) as d:
        assert d is None
    td = str(tmp_path / "trace")
    with metrics.profile_trace(True, td) as d:
        assert d == td
        torch.ones(8).sum()
    assert json.load(open(os.path.join(td, "trace.json")))["traceEvents"]


def _cli(tmp_path, name, *args, cuda=True):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(ROOT / "bin" / name), *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)


def _config(tmp_path):
    path = tmp_path / "cornell16.json"
    path.write_text(json.dumps({"scene": "cornell", "height": 16, "width": 16,
                                "max_bounces": 1, "smooth_shading": False}))
    return path.name


def test_trace_torch_cpu(tmp_path):
    proc = _cli(tmp_path, "trace_torch", "--preset", _config(tmp_path), "--cpu", "-o", "out.png")
    assert proc.returncode == 0, proc.stderr
    assert "overflow 0" in proc.stdout
    img = image.read_png(str(tmp_path / "out.png"))
    assert img.shape == (16, 16, 3) and 0 < img.mean() < 255


def test_fit_torch_cpu(tmp_path):
    proc = _cli(tmp_path, "fit_torch", "--preset", _config(tmp_path), "--cpu", "--steps", "4",
                "--ckpt", "ck", "--ckpt-every", "2", "--metrics", "m.jsonl", "-o", "fit")
    assert proc.returncode == 0, proc.stderr
    assert "(4 steps run)" in proc.stdout
    assert [json.loads(line)["step"] for line in open(tmp_path / "m.jsonl")] == [0, 1, 2, 3]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001", "step_00000003"]
    for name in ("target", "initial", "final"):
        assert image.read_png(str(tmp_path / f"fit_{name}.png")).shape == (16, 16, 3)


def test_clis_refuse_without_cuda(tmp_path):
    """Without CUDA and without --cpu: a non-zero exit, nothing on stdout,
    no file written."""
    cfg = _config(tmp_path)
    for name, extra in (("trace_torch", ["-o", "out.png"]), ("fit_torch", ["-o", "fit"]),
                        ("bench_torch", ["--no-grad"])):
        proc = _cli(tmp_path, name, "--preset", cfg, *extra, cuda=False)
        assert proc.returncode != 0 and proc.stdout == "", (name, proc.stdout)
        assert "CUDA is not available" in proc.stderr
    assert sorted(os.listdir(tmp_path)) == [cfg]


def test_bench_torch_cpu(tmp_path):
    """bin/bench_torch --cpu: bench_torch.py's line (its metric, the frame's
    ms and overflow 0, the device named), exit 0; --scaling --cpu prints
    bench.py's scaling table over 1 and 2 gloo ranks, the first at 100 %."""
    proc = _cli(tmp_path, "bench_torch", "--cpu", "--preset", "cornell256", "--iters", "1",
                "--no-grad")
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "rays_per_s_per_chip_100ktri_1080p" and line["value"] > 0
    assert line["detail"]["overflow"] == 0 and line["detail"]["device"] == "cpu"
    assert line["detail"]["preset"] == "cornell256" and "grad_step_ms" not in line["detail"]
    proc = _cli(tmp_path, "bench_torch", "--scaling", "--cpu", "--preset", _config(tmp_path),
                "--iters", "1")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "| Topology | rays/s | scaling efficiency | status |" and len(lines) == 4
    assert lines[2].startswith("| 1x CPU rank |") and "| 100.0% |" in lines[2]
    assert lines[3].startswith("| 2x CPU rank |") and lines[3].endswith("timings not hardware) |")


def test_dist_config_matches_reference():
    """The same fields, in the same order, with the same defaults."""
    import dataclasses

    want = [(f.name, f.default) for f in dataclasses.fields(JDistConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(DistConfig)] == want


def test_benchmark_profile_writes_trace(tmp_path, monkeypatch):
    """profile=True: api.benchmark traces its timed loop into
    $TRACER_PROFILE_DIR/trace.json; make_grad_step_fn accepts it too."""
    monkeypatch.setenv("TRACER_PROFILE_DIR", str(tmp_path / "prof"))
    cfg = load_config("cornell256", height=16, width=16, profile=True)
    res = api.benchmark(cfg, iters=1, warmup=1, device="cpu")
    assert res["overflow"] == 0 and res["device"] == "cpu"
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    api.make_grad_step_fn(cfg, device="cpu")
