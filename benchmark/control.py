"""The readings that a cell's limits are set from, many seeds in one
process, at the cell's own sizes:

    python3 benchmark/control.py --workload <cell> --mode <mode> \
        --seeds 11,12,13 [--seconds 2]

mode "program": the program's numbers, as a run compares them (training:
its first three steps and its first grid update outside warm-up against
the reference's, with the update's controls; render: a short window of
chunks). mode "fp8": the control, the reference computed in float8
put in the program's place. mode "half_batch": the planted fault of a
step over half of its batch (the reference's, in the program's place);
for a render cell, half of each chunk left unrendered, and "altered",
one colour changed in each chunk (the program's, planted).

One JSON line a seed: {"seed", "mode", numbers...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(cell, seed: int, mode: str, device,
                   psnr_steps: tuple = ()) -> dict:
    """The first steps' numbers, as a run compares them. Mode "program"
    also gives the numbers of the first grid update outside warm-up, for
    the program ("update_*") and, in its place, for the reference in
    float8 ("fp8_update_*"), for the grids left as they were
    ("unchanged_update_*") and for the reference without the decay
    ("no_decay_update_*"); and with `psnr_steps`, the held-out PSNR,
    samples a ray and march iterations a chunk at each of those steps."""
    from benchmark.drivers import common
    from benchmark.drivers import train as drv
    from benchmark.reference.scene import make_scene

    seeds = common.seeds(seed)
    out = {}
    if mode == "program":
        scene, trainer = drv.build(cell, seeds, device)
        got = drv.first_steps(trainer)
        trainer.fit_steps(drv.first_update_step(trainer.tcfg.warmup_steps)
                          - trainer.global_step)
        up = drv.update_step(trainer)
        for step in psnr_steps:
            trainer.fit_steps(step - trainer.global_step)
            held = drv.held_out(cell, scene, trainer)
            out[f"at_{step}"] = {k: round(v, 4) for k, v in held.items()}
        del trainer
        common.free(device)
        ref_up = drv.reference_update(cell, up, device)
        out.update(drv.compare_update(up["grid"], up["occ"], ref_up))
        out.update({f"unchanged_{k}": v for k, v in drv.compare_update(
            up["before"]["grid"], up["before"]["occ"], ref_up).items()})
        for name, kw in (("fp8", {"prec": "fp8"}),
                         ("no_decay", {"decay": 1.0})):
            lo = drv.reference_update(cell, up, device, **kw)["lo"]
            out.update({f"{name}_{k}": v for k, v in drv.compare_update(
                lo["grid"], lo["occ"], ref_up).items()})
        del up, ref_up
    else:
        scene = make_scene(cell["config"]["scene"], device)
        got = drv.reference_readings(
            cell, seeds, scene, device,
            prec="fp8" if mode == "fp8" else "f32",
            fault="half_batch" if mode == "half_batch" else None)
    ref = drv.reference_readings(cell, seeds, scene, device)
    return {**drv.compare(got, ref), **out,
            "worst": drv.worst_leaves(got, ref)}


def render_readings(cell, seed: int, mode: str, seconds: float,
                    device) -> dict:
    from benchmark.drivers import common
    from benchmark.drivers import render as drv

    seeds = common.seeds(seed)
    model, scene, weights, occ, render, chunk = drv.build(cell, seeds,
                                                          device)
    scene["mean_dir"] = scene["directions"].mean(0)
    ref = common.reference(cell["config"])
    render = drv.plant(render, mode if mode in ("altered", "half_batch")
                       else None)
    _, done = drv.window(render, scene, drv.chunks(scene, chunk), seconds,
                         device, cell["traffic"]["kept_rays_per_chunk"],
                         seeds["check"])
    rgb, pix, views = drv.check_sample(
        done, cell["traffic"]["check_rays"], seeds["check"])
    theirs = drv.reference_render(ref, pix, views, scene, model, weights, occ)
    if mode == "fp8":
        # the control in the program's place: the reference in float8
        rgb = drv.reference_render(ref, pix, views, scene, model, weights,
                                   occ, "fp8")["rgb"]
    return drv.gaps(rgb, theirs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "fp8", "half_batch", "altered"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--psnr_steps", default="",
                    help="training: steps at which to render the held-out "
                    "rays (mode program)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run

    spec = run.load_json(ROOT, "BENCHMARK.json")
    cell = run.find_cell(spec, args.workload)
    device = torch.device(args.device)
    torch.set_num_threads(2)
    for s in args.seeds.split(","):
        t0 = time.time()
        if cell["traffic"]["driver"] == "train":
            nums = train_readings(
                cell, int(s), args.mode, device,
                tuple(int(v) for v in args.psnr_steps.split(",") if v))
        else:
            nums = render_readings(cell, int(s), args.mode, args.seconds,
                                   device)
        print(json.dumps({"seed": int(s), "mode": args.mode, **nums,
                          "seconds": round(time.time() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
