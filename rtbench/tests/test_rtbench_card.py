"""On the card, at each cell's own size: a short run of rtbench/run.py
keeps to the result line's contract and is correct, and the control (the
reference with TF32 products in the program's place) fails the cell's
numbers on three seeds. Marked `card`; each test skips, with the reason,
where torch sees no CUDA card. Run them on the card with

    python3 -m pytest rtbench/tests -m card -q
"""
import json
import subprocess
import sys
import time

import pytest
import torch

from rtbench import calibrate, checks, harness

WORKLOADS = [w["name"] for w in harness.load_bench()["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_keeps_to_the_line(name, trace):
    need_card()
    out = subprocess.run([sys.executable, "rtbench/run.py", "--workload", name, "--seed",
                          str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line["checks"]
    cell = harness.load_cell(name)
    assert set(line["metrics"]) == set(cell.per_layer if trace else cell.end_to_end)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"] and line["breakdown"]["device_ops"]
    assert out.stderr.strip().splitlines()[-len(line["checks"]):][0].startswith("check ")


@pytest.mark.card
@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_fails_at_the_cells_size(name):
    need_card()
    cell = harness.load_cell(name)
    dev = torch.device("cuda")
    for seed in SEEDS:
        res = harness.run_cell(cell, seed, 2.0, False, "cuda", time.time())
        assert res["correct"], res["checks"]
        if cell.traffic["loop"] == "frames":
            values = dict(calibrate.frame_control(res, dev), overflow=0)
        else:
            values = dict(calibrate.grad_readings(res, dev)["control"], overflow=0)
        ok, judged = checks.judge(values, cell.limits)
        assert not ok, judged
