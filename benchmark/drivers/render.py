"""Render cells: the system's validation render (render_rays_chunked,
chunks of --val_chunk rays) of the held-out views, one chunk a call, at
the seed's weights and an occupancy set from the scene's geometry.

The comparison (after the window, the program freed): a sample of the
rays rendered in the window, drawn from the seed, rendered again by the
reference; the widest colour and opacity gaps are held to their limits.
"""

from __future__ import annotations

import time

import torch

from ..reference import nerf
from ..reference.scene import make_scene, make_weights, statue_occupancy
from . import common



def build(cell: dict, seeds: dict, device):
    conf, traffic = cell["config"], cell["traffic"]
    model = dict(conf["model"], **traffic["weights"])
    scene = make_scene(conf["scene"], device, images=False)
    ref = common.reference(conf)
    weights = make_weights(ref.param_spec(model), seeds["weights"], device)
    occ = statue_occupancy(model["density_grid_size"], model["scale"],
                           model["n_experts"], device)
    render, chunk = common.system(conf).build_viewer(
        conf["flags"] + traffic["flags"] + cell["cell"]["flags"],
        conf["model"], weights, occ, device)
    return model, scene, weights, occ, render, chunk


def chunks(scene: dict, chunk: int):
    """(view, first ray, end) of every chunk of every held-out view, in
    the order a validation renders them."""
    n = scene["directions"].shape[0]
    return [(v, a, min(a + chunk, n))
            for v in range(len(scene["test_poses"]))
            for a in range(0, n, chunk)]


def plant(render, fault: str | None):
    """A planted fault (for the benchmark's own tests): "altered" adds
    0.1 to the red of every 16th ray of a chunk; "half_batch" leaves the
    second half of each chunk's rays unrendered (background, opacity
    0)."""
    if fault is None:
        return render

    def broken(dirs, pose, mean_dir):
        out = dict(render(dirs, pose, mean_dir))
        rgb, op = out["rgb"].clone(), out["opacity"].clone()
        if fault == "altered":
            rgb[::16, 0] += 0.1
        elif fault == "half_batch":
            h = rgb.shape[0] // 2
            rgb[h:], op[h:] = 1.0, 0.0
        else:
            raise ValueError(f"unknown fault {fault!r}")
        out["rgb"], out["opacity"] = rgb, op
        return out

    return broken


def _span(render, todo, scene, with_stack: bool, device) -> dict:
    """Profile the render of one whole held-out view, chunk by chunk."""
    from torch.profiler import ProfilerActivity, profile

    from ..reference import trace as tr

    iters = samples = rays = 0
    picked = [c for c in todo if c[0] == 0]
    common.sync(device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        for v, a, b in picked:
            out = render(scene["directions"][a:b], scene["test_poses"][v],
                         scene["mean_dir"])
            iters += out["iterations"]
            samples += out["total_samples"]
            rays += b - a
        common.sync(device)
        wall = time.perf_counter() - t0
    events = tr.load_trace(prof)
    items = tr.device_items(events)
    _, _, frames_iv = tr.attribute(events)
    return {"items": items, "frames": frames_iv, "window_s": wall,
            "busy_s": tr.busy_us(items) / 1e6, "chunks": len(picked),
            "iterations": iters, "samples": samples, "rays": rays}


def window(render, scene, todo, seconds: float, device, keep: int,
           seed: int):
    """Chunks one after another until `seconds` have passed. Returns the
    wall time and each chunk's (view, first, end, kept rows, their rgb,
    iterations, samples): `keep` rays of each chunk, drawn from `seed`,
    are kept for the comparison."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    done = []
    i = 0
    t0 = time.perf_counter()
    while True:
        v, a, b = todo[i % len(todo)]
        out = render(scene["directions"][a:b], scene["test_poses"][v],
                     scene["mean_dir"])
        rows = torch.randint(0, b - a, (keep,), generator=gen).to(
            out["rgb"].device)
        done.append((v, a, b, rows, out["rgb"][rows], out["iterations"],
                     out["total_samples"]))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    return time.perf_counter() - t0, done


def check_sample(done: list, n: int, seed: int):
    """n of the kept (chunk, row) pairs, drawn from `seed`: the program's
    colours there, and the rays' pixels and views."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    per = done[0][3].numel()
    pick = torch.randperm(len(done) * per, generator=gen)[:n].tolist()
    rgb = torch.stack([done[p // per][4][p % per] for p in pick])
    pix = [done[p // per][1] + int(done[p // per][3][p % per])
           for p in pick]
    views = [done[p // per][0] for p in pick]
    return rgb, pix, views


def reference_render(ref, pix, views, scene, model, weights, occ,
                     prec: str = "f32") -> dict:
    """The reference's render of the rays of pixels `pix` of views
    `views`."""
    dirs = scene["directions"][torch.tensor(pix)]
    poses = scene["test_poses"][torch.tensor(views)]
    o, d = nerf.get_rays(dirs, poses)
    return ref.render({"model": model, "weights": weights}, o, d,
                      nerf.Prec(prec), occ)


def gaps(rgb, theirs: dict) -> dict:
    """The widest colour gap (any channel)."""
    return {"rgb_gap": float((rgb - theirs["rgb"]).abs().max())}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None, log=print) -> dict:
    conf, traffic = cell["config"], cell["traffic"]
    seeds = common.seeds(seed)
    log(f"set-up: imports {time.time() - t_start:.2f} s")
    model, scene, weights, occ, render, chunk = build(cell, seeds, device)
    common.sync(device)
    log(f"set-up: scene, weights, viewer {time.time() - t_start:.2f} s")
    render = plant(render, fault)
    scene["mean_dir"] = scene["directions"].mean(0)
    todo = chunks(scene, chunk)
    for v, a, b in todo[:traffic["warm_chunks"]]:
        render(scene["directions"][a:b], scene["test_poses"][v],
               scene["mean_dir"])
    common.sync(device)
    setup_s = time.time() - t_start

    wall, done = window(render, scene, todo, seconds, device,
                        traffic["kept_rays_per_chunk"], seeds["check"])
    rays = sum(c[2] - c[1] for c in done)
    iters = sum(c[5] for c in done)
    samples = sum(c[6] for c in done)
    log(f"window: {len(done)} chunks of {chunk} rays, {rays} rays, "
        f"{iters} march iterations, {wall:.3f} s")
    peak = common.memory_peak(device)
    ref = common.reference(conf)
    ctx = {"kind": "render", "model": model, "reference": ref,
           "window": {"seconds": wall, "chunks": len(done), "rays": rays,
                      "iterations": iters, "samples": samples,
                      "chunk": chunk},
           "memory_peak_bytes": peak}
    if trace:
        ctx["span"] = _span(render, todo, scene, False, device)
        ctx["span_stack"] = _span(render, todo, scene, True, device)
    rgb, pix, views = check_sample(done, traffic["check_rays"],
                                   seeds["check"])
    del render, done
    common.free(device)
    numbers = gaps(rgb, reference_render(ref, pix, views, scene, model,
                                         weights, occ))
    return {"e2e": {"render_rays_per_s": rays / wall, "setup_s": setup_s},
            "ctx": ctx, "numbers": numbers,
            "attempted": ctx["window"]["chunks"], "failed": 0}
