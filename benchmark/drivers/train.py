"""Training cells: the system's Trainer driven from the seed through its
first steps and through its first grid update outside warm-up (their
readings kept for the comparison), on to the start step, then
`Trainer.fit_steps` for the measured window.

The comparison (after the window, the program freed): the reference
follows the same first three steps from the same inputs; each step's
loss, the first gradient's norm per leaf (from Adam's first moment after
one step) and each leaf's change after three steps are held against it,
and so is the occupancy of the first grid update. The reference then
makes the update outside warm-up from the program's state before it
(weights, grids, generator), and the grids and occupancy after it are
held against its own.
"""

from __future__ import annotations

import collections
import math
import time

import torch

from ..reference import nerf
from ..reference.scene import held_out_rays, make_scene, make_weights
from . import common

FIRST_STEPS = 3
UPDATE_INTERVAL = 16         # steps between grid updates
SPAN_STEPS = 16              # a traced span: one grid update and its steps


def _paths_leaves(trainer):
    from radnerf_tpu_torch.parallel.step import tree_leaves, tree_paths

    return tree_paths(trainer.bundle), tree_leaves(trainer.bundle)


def first_steps(trainer, n: int = FIRST_STEPS) -> dict:
    """Drive the trainer through its first n steps through fit_steps and
    keep what the comparison reads: each step's loss, the first
    gradient's norm per leaf (Adam's first moment after one step over
    1 - beta1), each leaf's change after n steps, and the occupancy the
    first grid update left (grids, G^3)."""
    paths, leaves = _paths_leaves(trainer)
    p0 = [p.detach().clone() for p in leaves]
    losses = []
    trainer.fit_steps(1, lambda s, loss, aux: losses.append(loss.detach()))
    occ = trainer.model_state["occ"].reshape(
        -1, trainer.cfg.grid_size ** 3).clone()
    opt = trainer.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    # an optimizer that kept no state for a leaf was handed no gradient
    grad0 = {k: opt.state[p]["exp_avg"].norm() / (1 - b1)
             if "exp_avg" in opt.state.get(p, {}) else torch.zeros(())
             for k, p in zip(paths, leaves)}
    trainer.fit_steps(n - 1,
                      lambda s, loss, aux: losses.append(loss.detach()))
    change = {k: (p.detach() - q).norm()
              for k, p, q in zip(paths, leaves, p0)}
    return {"loss": [float(v) for v in losses],
            "grad0": {k: float(v) for k, v in grad0.items()},
            "change": {k: float(v) for k, v in change.items()}, "occ": occ}


def first_update_step(warmup_steps: int) -> int:
    """The step of the first grid update outside warm-up."""
    return -(-warmup_steps // UPDATE_INTERVAL) * UPDATE_INTERVAL


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def update_step(trainer) -> dict:
    """Drive the trainer through the step of a grid update (through
    fit_steps) and keep what the update's comparison reads: the weights,
    grids, occupancy and generator state before it, and the grids and
    occupancy after it (grids, G^3), all on the host."""
    if trainer.global_step % UPDATE_INTERVAL:
        raise ValueError(f"step {trainer.global_step} updates no grid")
    G3 = trainer.cfg.grid_size ** 3
    paths, leaves = _paths_leaves(trainer)
    st = trainer.model_state
    before = {"weights": {k: _host(p) for k, p in zip(paths, leaves)},
              "grid": _host(st["density_grid"].reshape(-1, G3)),
              "occ": _host(st["occ"].reshape(-1, G3)),
              "gen": trainer.gen.get_state()}
    trainer.fit_steps(1)
    st = trainer.model_state
    return {"before": before,
            "grid": _host(st["density_grid"].reshape(-1, G3)),
            "occ": _host(st["occ"].reshape(-1, G3))}


def reference_update(cell: dict, up: dict, device, prec: str = "f32",
                     decay: float = 0.95) -> dict:
    """The reference's grid update from the state before the program's
    (its weights, grids and generator state): {"lo", "hi"} -> {"grid",
    "occ"}."""
    conf = cell["config"]
    f = nerf.Field(conf["model"])
    f.check_scope()
    gen = torch.Generator(device=device)
    gen.set_state(up["before"]["gen"])
    p = {k: v.to(device) for k, v in up["before"]["weights"].items()}
    return common.reference(conf).update_grid(
        p, up["before"]["grid"].to(device), gen, f, nerf.Prec(prec), decay)


def compare_update(grid: torch.Tensor, occ: torch.Tensor,
                   ref: dict) -> dict:
    """The numbers compared of a grid update: the share of cells whose
    occupancy is neither of the two the reference allows (a cell drawn
    twice keeps one of its draws), and the distance of the grid's values
    from the reference's range, summed over the cells, over the sum of
    the reference's positive values."""
    lo = torch.minimum(ref["lo"]["grid"], ref["hi"]["grid"])
    hi = torch.maximum(ref["lo"]["grid"], ref["hi"]["grid"])
    g = grid.to(lo.device)
    dist = (lo - g).clamp_min(0) + (g - hi).clamp_min(0)
    o, a, b = occ.to(lo.device), ref["lo"]["occ"], ref["hi"]["occ"]
    bad = (o & ~a & ~b) | (~o & a & b)
    return {"update_occ_gap": float(bad.float().mean()),
            "update_grid_gap": float(dist.sum()
                                     / hi.clamp_min(0).sum().clamp_min(1e-30))}


def reference_inputs(cell: dict, seeds: dict, scene: dict, device) -> dict:
    conf, traffic = cell["config"], cell["traffic"]
    ref = common.reference(conf)
    tr = dict(conf["train"], **cell["cell"].get("train", {}),
              batch_size=traffic["batch_size"], gen_seed=seeds["gen"])
    return {"model": conf["model"], "scene": scene, "train": tr,
            "weights": make_weights(ref.param_spec(conf["model"]),
                                    seeds["weights"], device)}


def reference_readings(cell, seeds, scene, device, prec="f32", fault=None):
    """The reference's first three steps: losses, first gradient norms,
    changes per leaf, and its first grid update's occupancy."""
    ref = common.reference(cell["config"])
    inputs = reference_inputs(cell, seeds, scene, device)
    out = ref.train(inputs, FIRST_STEPS, nerf.Prec(prec), fault)
    return {"loss": out["loss"], "grad0": out["grad0"], "occ": out["occ"],
            "change": {k: float((out["weights"][k] - inputs["weights"][k])
                                .norm()) for k in out["weights"]}}


def worst_leaves(got: dict, ref: dict) -> dict:
    """The leaf that sets grad_gap and the one that sets change_gap (for
    the log)."""
    g_med = sorted(ref["grad0"].values())[len(ref["grad0"]) // 2]
    moved = [k for k, v in ref["grad0"].items() if v >= 1e-3 * g_med]
    c_med = sorted(ref["change"][k] for k in moved)[len(moved) // 2]
    return {
        "grad_gap": max(ref["grad0"], key=lambda k: abs(
            got["grad0"][k] - ref["grad0"][k]) / max(ref["grad0"][k], g_med,
                                                     1e-30)),
        "change_gap": max(moved, key=lambda k: abs(
            got["change"][k] - ref["change"][k]) / max(ref["change"][k],
                                                       c_med, 1e-30))}


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the share of grid cells whose first
    occupancy differs; the largest relative gap of a step's loss; by the
    worst leaf, the gap between the norms of the first gradient and of
    the change, each over the reference's norm of that leaf or of the
    median leaf, whichever is larger. Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of the change. Each side's steps march its own first
    occupancy."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(got["loss"], ref["loss"]))
    g_med = sorted(ref["grad0"].values())[len(ref["grad0"]) // 2]
    grad_gap = max(abs(got["grad0"][k] - v) / max(v, g_med, 1e-30)
                   for k, v in ref["grad0"].items())
    moved = [k for k, v in ref["grad0"].items() if v >= 1e-3 * g_med]
    c_med = sorted(ref["change"][k] for k in moved)[len(moved) // 2]
    change_gap = max(abs(got["change"][k] - ref["change"][k])
                     / max(ref["change"][k], c_med, 1e-30) for k in moved)
    occ_gap = float((got["occ"] != ref["occ"]).float().mean())
    return {"occ_gap": occ_gap, "loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def plant(trainer, fault: str | None) -> None:
    """A planted fault under the timed path (for the benchmark's own
    tests): "unchanged" steps leave the weights as they were;
    "grid_unchanged" grid updates outside warm-up leave the grids as
    they were; "half_batch" takes each step's loss over the first half
    of the batch."""
    if fault is None:
        return
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "grid_unchanged":
        inner_update = trainer.update_grid
        trainer.update_grid = lambda warmup: (inner_update(warmup) if warmup
                                              else None)
    elif fault == "half_batch":
        inner = trainer.loss_fn

        def half(b, s, batch, d, *a):
            n = next(iter(batch.values())).shape[0] // 2
            return inner(b, s, {k: v[:n] for k, v in batch.items()}, d, *a)

        trainer.loss_fn = half
    else:
        raise ValueError(f"unknown fault {fault!r}")


def build(cell: dict, seeds: dict, device, fault=None):
    """The scene, and the system's trainer on the seed's weights."""
    conf, traffic = cell["config"], cell["traffic"]
    scene = make_scene(conf["scene"], device)
    ref = common.reference(conf)
    weights = make_weights(ref.param_spec(conf["model"]), seeds["weights"],
                           device)
    trainer = common.system(conf).build_trainer(
        conf["flags"] + traffic["flags"] + cell["cell"]["flags"],
        conf["model"], scene, weights, seeds["gen"], device)
    common.check_train(trainer.tcfg, dict(conf["train"],
                                          **cell["cell"].get("train", {})),
                       traffic)
    plant(trainer, fault)
    return scene, trainer


def _window_counts(trainer, aux_list, budgets) -> dict:
    """The valid samples of the steps recorded (the union's for the MoE):
    each step's share of its budget used times the budget."""
    if not aux_list:
        return {"valid": 0.0}
    util = torch.stack([a["budget_util"] for a in aux_list])
    bud = torch.tensor([slots_per_ray(trainer, b) for b in budgets],
                       dtype=torch.float32, device=util.device)
    return {"valid": float((util * bud).sum()) * trainer.tcfg.batch_size}


def slots_per_ray(trainer, budget: int) -> int:
    """Slots a ray has in a step's sample buffer at budget `budget`: the
    MoE's union stream holds the budget times union_budget_factor, or
    times the number of experts where the factor is 0 (no adaptive
    budget)."""
    if not trainer.moe:
        return budget
    return max(1, round(budget * (trainer.rcfg.union_budget_factor
                                  or trainer.cfg.n_experts)))


def _span(trainer, n_steps: int, with_stack: bool, device) -> dict:
    """Profile n_steps steps (from a grid-update boundary): the device
    items, the host wall, and the steps' sample counts."""
    from torch.profiler import ProfilerActivity, profile

    from ..reference import trace as tr

    aux_list, budgets = [], []
    torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            trainer.fit_steps(1, lambda s, loss, aux: aux_list.append(aux))
            budgets.append(trainer.rcfg.budget_per_ray)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = tr.load_trace(prof)
    items = tr.device_items(events)
    _, _, frames_iv = tr.attribute(events)
    return {"items": items, "frames": frames_iv, "window_s": wall,
            "busy_s": tr.busy_us(items) / 1e6, "steps": n_steps,
            "updates": sum(1 for i in range(n_steps) if i % 16 == 0),
            **_window_counts(trainer, aux_list, budgets)}


def held_out(cell: dict, scene: dict, trainer) -> dict:
    """The system's test render of the held-out rays at the trainer's
    state: the PSNR, and the samples a ray and march iterations a chunk
    it took."""
    traffic = cell["traffic"]
    held = held_out_rays(scene, traffic["held_out_rays"])
    render = common.system(cell["config"]).test_render(trainer)
    chunk, rgb, samples, iters = traffic["held_out_chunk"], [], 0, 0
    with torch.no_grad():
        for a in range(0, held["o"].shape[0], chunk):
            out = render(held["o"][a:a + chunk], held["d"][a:a + chunk])
            rgb.append(out["rgb"])
            samples += int(out["total_samples"])
            iters += int(out["iterations"])
    rgb = torch.cat(rgb)
    n = held["o"].shape[0]
    mse = float(((rgb - held["rgb"]) ** 2).mean())
    return {"psnr": -10.0 * math.log10(max(mse, 1e-12)),
            "samples_per_ray": samples / n,
            "iters_per_chunk": iters / -(-n // chunk)}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None, log=print) -> dict:
    conf, traffic = cell["config"], cell["traffic"]
    model = conf["model"]
    seeds = common.seeds(seed)
    log(f"set-up: imports {time.time() - t_start:.2f} s")
    scene, trainer = build(cell, seeds, device, fault)
    common.sync(device)
    log(f"set-up: scene, weights, trainer {time.time() - t_start:.2f} s")
    mine = first_steps(trainer)
    log(f"set-up: first steps {time.time() - t_start:.2f} s")
    upd = first_update_step(trainer.tcfg.warmup_steps)
    if traffic["start_step"] <= upd:
        raise ValueError(f"the window has to start after step {upd}")
    trainer.fit_steps(upd - FIRST_STEPS)
    mine_up = update_step(trainer)
    trainer.fit_steps(traffic["start_step"] - trainer.global_step)
    common.sync(device)
    setup_s = time.time() - t_start
    log(f"set-up: to step {trainer.global_step} {setup_s:.2f} s")

    budgets, aux_list = [], []
    step0 = trainer.global_step
    t0 = time.perf_counter()
    while True:
        trainer.fit_steps(1, lambda s, loss, aux: aux_list.append(aux))
        budgets.append(trainer.rcfg.budget_per_ray)
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    wall = time.perf_counter() - t0
    steps = trainer.global_step - step0
    B = trainer.tcfg.batch_size
    counts = _window_counts(trainer, aux_list, budgets)
    del aux_list
    updates = sum(1 for s in range(step0, step0 + steps) if s % 16 == 0)
    log(f"window: steps {step0}-{step0 + steps - 1} ({steps}), grid "
        f"updates {updates}, budget buckets "
        f"{dict(sorted(collections.Counter(budgets).items()))}, "
        f"{wall:.3f} s")

    ref = common.reference(conf)
    held = held_out(cell, scene, trainer)
    log(f"held-out render: {held['samples_per_ray']:.3f} samples a ray, "
        f"{held['iters_per_chunk']:.2f} march iterations a "
        f"{traffic['held_out_chunk']}-ray chunk")
    peak = common.memory_peak(device)

    ctx = {"kind": "train", "model": model, "reference": ref,
           "window": {"seconds": wall, "steps": steps, "rays": steps * B,
                      "updates": updates, **counts},
           "memory_peak_bytes": peak}
    if trace:
        while trainer.global_step % 16:
            trainer.fit_steps(1)
        ctx["span"] = _span(trainer, SPAN_STEPS, False, device)
        ctx["span_stack"] = _span(trainer, SPAN_STEPS, True, device)
    del trainer
    common.free(device)

    theirs = reference_readings(cell, seeds, scene, device)
    numbers = compare(mine, theirs)
    numbers.update(compare_update(mine_up["grid"], mine_up["occ"],
                                  reference_update(cell, mine_up, device)))
    log(f"worst leaves: {worst_leaves(mine, theirs)}")
    return {"e2e": {"train_rays_per_s": steps * B / wall,
                    "held_out_psnr_db": held["psnr"], "setup_s": setup_s},
            "ctx": ctx, "numbers": numbers, "attempted": steps,
            "failed": 0}
