"""Guards on the port's boundaries that need no card: tracer_torch,
chip_smoke.py, bin/bench_torch, bin/fit_torch and bin/trace_torch import
neither JAX nor the JAX package; chip_smoke.py refuses to run (non-zero
exit, no result line) without CUDA or outside the repository, and times
nothing (the benchmark, rtbench/, is the one yardstick of the port)."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|tracer)(\s|\.|$)", re.M)


def test_port_imports_no_jax():
    files = sorted((ROOT / "tracer_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bin" / "bench_torch", ROOT / "bin" / "fit_torch",
        ROOT / "bin" / "trace_torch"]
    assert len(files) > 10
    bad = [str(f.relative_to(ROOT)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, f"imports jax or tracer: {bad}"


def test_chip_smoke_times_nothing():
    """No clock, CUDA event, profiler or roofline model in chip_smoke.py:
    the port's times and bounds come from rtbench/ alone."""
    src = (ROOT / "chip_smoke.py").read_text()
    found = re.findall(r"torch\.cuda\.Event|time\.perf_counter|torch\.profiler|"
                       r"\b(?:PEAK|FLOPS)_\w*", src)
    assert not found, f"chip_smoke.py measures: {sorted(set(found))}"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
