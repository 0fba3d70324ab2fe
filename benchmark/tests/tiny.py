"""A cell cut to a size the CPU runs in seconds (a 40x30 scene of 4
views, a 2^12 table, a 16^3 grid, 128-ray steps, warm-up to step 16,
512-ray chunks), for
the benchmark's own tests: the same code paths as on the card, with the
program's kernels replaced by their plain twins."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

SPEC = run.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [w["name"] for w in SPEC["workloads"]
         if run.find_cell(SPEC, w["name"])["traffic"]["driver"] == "train"]
RENDER = [n for n in CELLS if n not in TRAIN]


# At this size one grid cell is a thousandth of a grid or more and each
# ray a hundredth of a batch, so the few cells at the threshold that fall
# the other way in bf16 read far larger than on the card: where the card's
# limit is tighter, the CPU size takes its own (above the largest of 9
# seeds' readings on the CPU; the float8 control and every fault still
# fail it).
TINY_LIMITS = {"update_occ_gap": 0.01, "loss_gap": 0.01, "grad_gap": 0.05}


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(run.find_cell(SPEC, name))
    c, t = cell["config"], cell["traffic"]
    lim = cell["cell"]["limits"]
    lim.update({k: max(lim[k], v) for k, v in TINY_LIMITS.items()
                if k in lim})
    c["flags"] = c["flags"] + ["--hash_table_size", "12"]
    c["model"].update(log2_hashmap_size=12, density_grid_size=16)
    c["scene"].update(img_wh=[40, 30], focal=60.0, n_train_views=4,
                      n_test_views=2)
    if t["driver"] == "train":
        # warm-up ends at step 16, so that the window follows the first
        # grid update outside it
        c["flags"] = c["flags"] + ["--warmup_steps", "16"]
        c["train"].update(warmup_steps=16)
        t.update(flags=["--batch_size", "128", "--microbatch", "1"],
                 batch_size=128, start_step=17, held_out_rays=256,
                 held_out_chunk=128)
    else:
        t.update(flags=["--val_chunk", "512"], check_rays=128)
    return cell


def tiny_run(name: str, seed: int = 2 ** 31 + 77, fault=None) -> dict:
    return run.run_cell(name, seed, 0.5, False, device="cpu", fault=fault,
                        spec=SPEC, cell=tiny_cell(name), log=lambda *a: None)
