#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process:

    python3 rtbench/calibrate.py --workload <name> --seconds 2 --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

For every seed, one run of the cell as rtbench/run.py makes it (a shorter
window): the program's numbers, the lower readings. For each control seed
also the control, the reference put in the program's place and computed
one precision below the configuration's float32 (TF32 products), against
the float32 reference on the same samples; and for a grad cell the fault
of half the image left out of the loss (the mean over the rest), planted
in the reference in the program's place, for the first steps and for the
step after the window. A step that returns its state unchanged reads
change_gap and late_change_gap 1 by their definition and needs no run.

One JSON line a seed on standard output.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def half_mse(img, target):
    """The fault: the loss over the first half of the rows only."""
    h = img.shape[0] // 2
    return ((img[:h] - target[:h]) ** 2).mean()


def frame_control(res, device) -> dict:
    import torch

    from rtbench import checks, harness, reference

    ex = res["extras"]
    rcfg = ex["rcfg"]
    prog, ref = [], []
    with torch.no_grad():
        for s in ex["samples"]:
            cam = harness.reference_camera(s["camera"], device)
            prog.append(reference.render_pixels(ex["ref_scene"], cam, rcfg.height, rcfg.width,
                                                s["ys"], s["xs"], rcfg.max_bounces, tf32=True))
            ref.append(s["ref"])
    return {"bad_pixel_share": checks.bad_pixel_share(torch.cat(prog), torch.cat(ref))}


def grad_readings(res, device) -> dict:
    """The control and the half-batch fault against the reference, for the
    first steps and for the step after the window (from the state the
    window left); and the step that returns its state unchanged."""
    import torch

    from rtbench import checks, plugins

    grad = plugins.load("loops", "grad", ROOT)
    ex = res["extras"]
    out = {}
    for name, kw in (("control", {"tf32": True}), ("half_batch", {"loss_fn": half_mse})):
        first = grad.reference_fit(ex["arrays"], ex["names"], ex["lr"], ex["target"],
                                   ex["rcfg"], device, **kw)
        late = grad.reference_late(ex["arrays"], ex["at"], ex["lr"], ex["target"], ex["rcfg"],
                                   device, **kw)
        out[name] = dict(checks.fit_numbers(first, ex["ref"]),
                         **checks.late_numbers(late, ex["late_ref"]))
    still = {k: dict(ex[k], change={n: torch.zeros_like(v) for n, v in ex[k]["change"].items()})
             for k in ("prog", "late")}
    out["state_unchanged"] = dict(checks.fit_numbers(still["prog"], ex["ref"]),
                                  **checks.late_numbers(still["late"], ex["late_ref"]))
    return out


def grad_look(res) -> dict:
    """What lies behind the fit's numbers: each step's loss on both sides and
    each leaf's first gradient (norms, cosine, sign disagreements)."""
    ex = res["extras"]
    p, r = ex["prog"], ex["ref"]
    leaves = {}
    for k in r["grad1"]:
        gp, gr = p["grad1"][k].double().flatten(), r["grad1"][k].double().flatten()
        leaves[k] = {"norm_prog": float(gp.norm()), "norm_ref": float(gr.norm()),
                     "cos": float(gp @ gr / (gp.norm() * gr.norm() + 1e-300)),
                     "sign_diff": int(((gp > 0) != (gr > 0)).sum()),
                     "nonzero_ref": int((gr != 0).sum())}
        if gr.numel() <= 6:
            leaves[k]["prog"] = gp.tolist()
            leaves[k]["ref"] = gr.tolist()
        dp, dr = ex["prog"]["change"][k].double(), ex["ref"]["change"][k].double()
        leaves[k]["change_prog"] = float(dp.norm())
        leaves[k]["change_ref"] = float(dr.norm())
        leaves[k]["change_diff"] = float((dp - dr).norm())
    return {"losses_prog": p["losses"], "losses_ref": r["losses"], "leaves": leaves,
            "late_loss_prog": ex["late"]["losses"], "late_loss_ref": ex["late_ref"]["losses"],
            "window_steps": len(ex["times"])}


def late_look(res, program_image, device) -> dict:
    """What lies behind the step after the window: each leaf's gradient on
    both sides (norms, cosine), every late number, and the pixels where the
    program's image of that step (its last render_tiled) and the
    reference's of the same state differ by more than checks.GATE_ABS."""
    import torch

    from rtbench import checks, harness, reference

    ex = res["extras"]
    leaves = {}
    for k, gr in ex["late_ref"]["grad1"].items():
        gp, gr = ex["late"]["grad1"][k].double().flatten(), gr.double().flatten()
        leaves[k] = {"n": gr.numel(), "norm_prog": float(gp.norm()), "norm_ref": float(gr.norm()),
                     "cos": float(gp @ gr / (gp.norm() * gr.norm() + 1e-300))}
    at, rcfg, arrays = ex["at"]["params"], ex["rcfg"], ex["arrays"]
    scene = harness.reference_scene(arrays, device, normals=False,
                                    **{k: at[k] for k in ("verts", "albedo") if k in at})
    cam = harness.reference_camera(arrays.camera, device)
    if "cam_pos" in at:
        cam["position"] = at["cam_pos"]
    with torch.no_grad():
        ref = reference.render_image(scene, cam, rcfg.height, rcfg.width, rcfg.max_bounces)
    bad = (program_image.float() - ref).abs().amax(-1) > checks.GATE_ABS
    return {"numbers": checks.late_numbers(ex["late"], ex["late_ref"]), "leaves": leaves,
            "bad_pixels": int(bad.sum()), "pixels": bad.numel()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    here = ROOT / "rtbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != here]

    import torch

    from rtbench import harness

    if not torch.cuda.is_available():
        sys.exit("rtbench: calibration needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    last = {}
    if cell.traffic["loop"] == "grad":
        # Keep the program's last image: that of the step after the window.
        from tracer_torch import api

        render = api.render_tiled

        def keeping(*a, **kw):
            out = render(*a, **kw)
            last["image"] = (out[0] if isinstance(out, tuple) else out).detach()
            return out

        api.render_tiled = keeping
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.time()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.time())
        line = {"workload": cell.name, "seed": seed, "correct": res["correct"],
                "program": {k: v["value"] for k, v in res["checks"].items()}}
        if cell.traffic["loop"] == "grad":
            line["look"] = grad_look(res)
            line["late_look"] = late_look(res, last.pop("image"), dev)
        if seed in args.control_seeds:
            if cell.traffic["loop"] == "frames":
                line["control"] = frame_control(res, dev)
            else:
                line.update(grad_readings(res, dev))
        line["seconds"] = time.time() - t0
        print(json.dumps(line, default=float), flush=True)
        del res
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
