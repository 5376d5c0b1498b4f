#!/usr/bin/env python3
"""Time bench.py's three grad steps in two source trees, in turns, on one
card: ROUNDS times parent, change, change, parent (each turn a fresh
process; ROUNDS defaults to 1).

    python3 ab_grad_pr10.py PARENT_TREE CHANGE_TREE [ROUNDS]

Each turn runs bench_torch.grad_steps() in the tree (its own kernel build)
and prints one JSON line {"tree", "turn", grad_step_ms of each step}, then
the card's name and power limit.
"""
import json
import subprocess
import sys

_TURN = """
import json, sys
sys.path.insert(0, '.')
import bench_torch
res = bench_torch.grad_steps()
print(json.dumps({k: v["grad_step_ms"] for k, v in res.items()}))
"""


def main() -> int:
    parent, change = sys.argv[1:3]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    order = (("parent", parent), ("change", change), ("change", change), ("parent", parent))
    for turn, (name, tree) in enumerate(order * rounds):
        out = subprocess.run([sys.executable, "-c", _TURN], cwd=tree, capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[-1]
        print(json.dumps({"tree": name, "turn": turn, **json.loads(out)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
