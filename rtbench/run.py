#!/usr/bin/env python3
"""Run one cell of the benchmark of tracer_torch once, on the card:

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is a `workloads` entry of
BENCHMARK.json. Prints, as the last line of standard output, one JSON
object {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "checks"}: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics and the profiled slice's busy and window
seconds. The numbers compared with the reference are also the last lines
of standard error, each beside its limit.

Exits non-zero and prints no result without CUDA or with fewer cards than
the cell asks for, without the program beside it, or when jax, jaxlib, flax
or tracer (whole top-level names) are loaded once the window has closed.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 1):
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Import the harness as rtbench.* from the checkout's root, not the
    # script's own directory, and keep every build cache in the checkout.
    here = ROOT / "rtbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    if not (ROOT / "tracer_torch" / "api.py").is_file():
        fail(f"the program (tracer_torch) is not beside {ROOT / 'rtbench'}")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "rtbench" / sub)

    import torch

    from rtbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"modules loaded in the run's process: {', '.join(bad)}")
    line = harness.result_line(cell, res, torch.device("cuda"))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
