"""bench_torch.py on the CPU at a tiny size: its line carries exactly
bench.py's keys plus detail.device, an overflow gives exit code 1, the
BENCH_* variables are honoured, and without CUDA it refuses to run. The
presets it reads are monkeypatched to the subdiv-2 bunny at 16x16."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tracer_torch.utils import config

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

TINY = dict(height=16, width=16, scene_arg=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small CPU ops; with several test workers on the
    machine, torch's intra-op threads only contend. One thread here, the
    caller's setting restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_py_keys() -> tuple[set, set]:
    """The top-level and detail keys of bench.py's line, read from its
    source (the *_error keys it writes when a grad step raises excluded)."""
    src = (ROOT / "bench.py").read_text()
    literal = re.search(r"detail = \{(.*?)\n    \}", src, re.S).group(1)
    detail = set(re.findall(r'"(\w+)":', literal)) | set(re.findall(r'detail\["(\w+)"\]', src))
    out = re.search(r"out = \{(.*?)\n    \}", src, re.S).group(1)
    return set(re.findall(r'"(\w+)":', out)), {k for k in detail if not k.endswith("_error")}


@pytest.fixture
def tiny(monkeypatch):
    for name in ("bench100k", "bunny-grad", "bunny512"):
        monkeypatch.setitem(config.PRESETS, name, config.PRESETS[name].replace(
            scene="bunny", **TINY))


def test_line_has_bench_py_keys(tiny):
    top, detail = bench_py_keys()
    assert {"grad_step_bunny512_jnp_ms", "live_rays_per_s", "ms_per_frame"} <= detail
    rc, line = bench_torch.run("bench100k", iters=1, grad=True, device="cpu")
    assert rc == 0
    assert set(line) == top
    assert set(line["detail"]) == detail | {"device"}
    d = line["detail"]
    assert d["device"] == "cpu" and d["preset"] == "bench100k" and d["grad_preset"] == "bunny-grad"
    assert d["overflow"] == 0 and d["grad_step_bunny512_overflow"] == 0
    assert min(d["ms_per_frame"], d["grad_step_ms"], d["grad_step_bunny512_ms"],
               d["grad_step_bunny512_jnp_ms"], line["value"]) > 0
    assert line["vs_baseline"] == line["value"] / bench_torch.BASELINE_RAYS_PER_S
    json.dumps(line)


def test_overflow_exits_1(tiny, monkeypatch):
    """A grad step that dropped candidates gives exit code 1; a frame that
    did gives bench.py's error line and exit code 1, before any grad step."""
    real_grad = bench_torch.benchmark_grad_step
    monkeypatch.setattr(bench_torch, "benchmark_grad_step",
                        lambda **kw: {**real_grad(**kw), "overflow": int(kw.get("tiled") == "off")})
    rc, line = bench_torch.run("bench100k", 1, True, device="cpu")
    assert rc == 1 and line["detail"]["grad_step_bunny512_overflow"] == 0
    real = bench_torch.benchmark
    monkeypatch.setattr(bench_torch, "benchmark", lambda *a, **k: {**real(*a, **k), "overflow": 2})
    monkeypatch.setattr(bench_torch, "grad_steps", lambda device: pytest.fail("grad step ran"))
    assert bench_torch.run("bench100k", 1, True, device="cpu") == (
        1, {"error": "bench frame dropped cull candidates", "overflow": 2})


def test_environment_is_honoured(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(bench_torch, "run", lambda *a: seen.append(a) or (0, {"value": 1.0}))
    monkeypatch.setattr(sys, "argv", ["bench_torch.py"])
    monkeypatch.setenv("BENCH_PRESET", "pod-1m")
    monkeypatch.setenv("BENCH_ITERS", "3")
    monkeypatch.setenv("BENCH_GRAD", "0")
    assert bench_torch.main() == 0
    assert seen == [("pod-1m", 3, False)]
    assert json.loads(capsys.readouterr().out) == {"value": 1.0}
    for var in ("BENCH_PRESET", "BENCH_ITERS", "BENCH_GRAD"):
        monkeypatch.delenv(var)
    assert bench_torch.main() == 0 and seen[-1] == ("bench100k", 10, True)
    capsys.readouterr()
    # --scaling prints scaling_rows' table, at BENCH_ITERS (default 5) as bench.py's does.
    monkeypatch.setattr(bench_torch, "scaling_rows",
                        lambda *a: seen.append(a) or ["| Topology |", "| row |"])
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--scaling"])
    assert bench_torch.main() == 0 and seen[-1] == ("bench100k", 5)
    assert capsys.readouterr().out == "| Topology |\n| row |\n"
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--bogus"])
    with pytest.raises(SystemExit, match="--bogus"):
        bench_torch.main()


def test_refuses_without_cuda():
    """The card is required: with no CUDA device visible the script exits
    non-zero, says why, and prints no JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "{" not in proc.stdout
