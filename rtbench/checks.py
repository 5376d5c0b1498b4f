"""The numbers that decide `correct`, each against its limit. A cell's
limits are rtbench/limits/<cell>.json; PERF.md gives the readings each was
set from.

Frames: the sampled pixels of the sampled frames against the reference,
  bad_pixel_share  share of them whose largest channel is off by more than
                   GATE_ABS (the repository's golden-image threshold);
  overflow         cull candidates the program dropped, summed over every
                   frame of the window (exact: 0).
Grad steps: the program's first three steps against the reference's,
  first_loss_gap  |L_prog - L_ref| / L_ref of the first step's loss (the
              later steps' losses are not compared: Adam moves every
              component whose gradient is noise by a whole step of the
              learning rate, and the few whose sign differs between the two
              sides move the images apart; PERF.md gives the readings);
  grad_gap    the worst leaf of |‖g_prog‖ - ‖g_ref‖| over the larger of
              ‖g_ref‖ of that leaf and of the median leaf, g the first
              step's gradient (the program's read back from Adam's state);
  change_gap  the same of the parameters' change over the three steps,
              over the leaves whose reference gradient is at least a
              thousandth of the median leaf's;
  late_loss_gap, late_change_gap
              the same of one more step after the window, from the
              parameters and Adam state the window left, against one
              reference step from that state (the change that step's);
              late_grad_gap, that step's gradient, is worked out but not
              compared: by then a few tie pixels on the fitted mesh move a
              leaf's gradient norm by up to 5 % between two sound
              implementations (PERF.md gives the readings);
  overflow    as for frames, over every step of the run.
"""
from __future__ import annotations

import statistics

import torch

GATE_ABS = 2e-3


def bad_pixel_share(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """(R, 3) against (R, 3) -> share of rows off by more than GATE_ABS."""
    return float(((prog - ref).abs().amax(-1) > GATE_ABS).float().mean())


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in leaves.items()}


def _gap(prog: dict, ref: dict, keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else 0.0
               for k in keys)


def fit_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [..], "grad1": {leaf: tensor}, "change": {leaf:
    tensor}} -> {"first_loss_gap", "grad_gap", "change_gap"}."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    return {"first_loss_gap": loss_gap, "grad_gap": _gap(g_prog, g_ref, list(g_ref)),
            "change_gap": _gap(_norms(prog["change"]), _norms(ref["change"]), moving)}


def late_numbers(prog: dict, ref: dict) -> dict:
    """fit_numbers of the one step after the window, as late_*."""
    return {f"late_{k}".replace("first_", ""): v for k, v in fit_numbers(prog, ref).items()}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every value within its limit, {name: {"value", "limit"}})."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    out = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
