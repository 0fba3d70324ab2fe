"""Plain reference of the Switch-NeRF baseline as Rad-NeRF trains it: one
hash table and one occupancy grid, a noisy top-1 point gate over each
sample's hash features (Shazeer et al.'s noisy gating with its
differentiable load), K expert MLPs mixed by the gate, then one density
and one colour head. The gate sees every slot of the march's fixed
budget, the empty ones at their ray's origin, as the method lays its
samples out; so do its noise rows and its load.

Leaves are named by path as the program's parameter tree is ("model/
hash_table", "model/inter/w/0", "model/gate/w_gate/w/0", ...); the random
draws (the grid update's jitter, the batch, the start jitter, the gate's
noise) come from a generator seeded as the program's, in the same order
and shapes.
"""

from __future__ import annotations

import math

import torch

from . import nerf
from .nerf import Field, Prec


def param_spec(m: dict) -> list:
    """[(path, shape, init, arg)]: the hash table, the K stacked expert
    MLPs, the gate's two MLPs, the geo and rgb heads."""
    K, L, T = m["n_experts"], m["n_levels"], 1 << m["log2_hashmap_size"]
    feat = L * m["n_features"]
    spec = [("model/hash_table", (L, T, 2), "uniform", m["table_init"])]

    def mlp(name, dims, lead=()):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            spec.append((f"{name}/w/{i}", lead + (a, b), "he", 1.0))
            spec.append((f"{name}/b/{i}", lead + (b,), "first", 0.0))

    inter = [feat] + [m["inter_hidden"]] * m["inter_layers"] + [feat]
    gate = [feat] + [m["gate_hidden"]] * m["gate_layers"] + [K]
    mlp("model/gate/w_gate", gate)
    mlp("model/gate/w_noise", gate)
    mlp("model/geo", [feat] + [m["geo_hidden"]] * m["geo_layers"]
        + [1 + m["geo_out"]])
    mlp("model/inter", inter, (K,))
    mlp("model/rgb", [m["sh_degree"] ** 2 + m["geo_out"]]
        + [m["rgb_hidden"]] * m["rgb_layers"] + [3])
    return spec


def _layers(p: dict, name: str):
    n = sum(1 for k in p if k.startswith(f"{name}/w/"))
    return ([p[f"{name}/w/{i}"] for i in range(n)],
            [p[f"{name}/b/{i}"] for i in range(n)])


def _cdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


def point_gate(p, feat, noise, prec: Prec, noise_eps: float = 1e-2):
    """Top-1 noisy gating of features (S, F): the gate (S, K), one-hot
    with the softmax of the top logit, and the load (K,): with noise, the
    summed probability of each expert staying first under re-noising,
    else the count of samples routed to it."""
    clean = nerf.mlp(*_layers(p, "model/gate/w_gate"), feat, prec)
    if noise is not None:
        raw = nerf.mlp(*_layers(p, "model/gate/w_noise"), feat, prec)
        std = torch.nn.functional.softplus(raw) + noise_eps
        noisy = clean + noise * std
    else:
        noisy = clean
    vals, idx = torch.sort(noisy, dim=-1, descending=True, stable=True)
    top_w = torch.softmax(vals[:, :1], dim=1)
    g = torch.zeros_like(noisy).scatter(1, idx[:, :1], top_w)
    if noise is None:
        return g, (g > 0).float().sum(0)
    thr_in, thr_out = vals[:, 1:2], vals[:, 0:1]
    prob = torch.where(noisy > thr_in, _cdf((clean - thr_in) / std),
                       _cdf((clean - thr_out) / std))
    return g, prob.sum(0)


def density_features(p, x, box, f: Field, prec: Prec, noise=None):
    """sigma (S,), the geo features (S, 16) and the gate's load."""
    feat = nerf.encode(p["model/hash_table"], x, box, f, prec)
    g, load = point_gate(p, feat, noise, prec)
    inter = nerf.mlp(*_layers(p, "model/inter"), feat, prec)   # (K, S, F)
    post = prec.q(torch.einsum("nk,knf->nf", g, inter))
    h = nerf.mlp(*_layers(p, "model/geo"), post, prec)
    return nerf.trunc_exp(h[:, 0]), h[:, 1:], load


def forward(p: dict, occ: torch.Tensor, o, d, jitter, gen, f: Field,
            prec: Prec, budget_per_ray: int, noise_k: int):
    """The training render: rgb (N, 3), opacity (N,) and the gate's load
    (K,); the gate's noise (budget, K) is drawn from `gen` here."""
    N = o.shape[0]
    box = f.scale
    t1, t2 = nerf.near_far(o, d, box)
    t, xyz, inside = nerf.lattice(o, d, t1, t2, f, jitter)
    keep = inside & occ[nerf.occ_cell(xyz, f)]
    del xyz
    B = N * budget_per_ray
    rid, ts, first, _ = nerf.march_budget(keep, t, f.samples_per_ray, B)
    S = ts.shape[0]
    slot_rid = torch.cat([rid, nerf.slot_ray_ids(first, B, N)[S:]])
    slot_t = torch.cat([ts, torch.zeros(B - S, device=ts.device)])
    x = nerf.fma(slot_t[:, None], d[slot_rid], o[slot_rid])
    noise = torch.randn((B, noise_k), generator=gen, device=o.device)
    sig, geo, load = density_features(p, x, box, f, prec, noise)
    rgb_in = torch.cat([prec.q(nerf.sh(d[slot_rid])), geo], -1)
    rgbs = nerf.mlp(*_layers(p, "model/rgb"), rgb_in, prec,
                    out_act="sigmoid")
    opac, _, col, _ = nerf.composite(sig[None, :S], rgbs[None, :S], ts,
                                     rid, N, f)
    return {"rgb": col[0], "opacity": opac[0], "load": load}


def loss(out: dict, target: torch.Tensor, w: dict) -> torch.Tensor:
    """Colour MSE, the opacity entropy and the cv^2 of the gate's load."""
    total = ((out["rgb"] - target) ** 2).mean()
    o = out["opacity"] + 1e-10
    total = total + w["opacity"] * (-o * torch.log(o)).mean()
    imp = out["load"]
    return total + w["cv"] * imp.var(unbiased=False) / (imp.mean() ** 2
                                                        + 1e-10)


def train(inputs: dict, n_steps: int, prec: Prec, fault: str | None = None):
    """As rad_moe.train, for the switch field (one grid: occupancy
    (1, G^3))."""
    m, sc, tr = inputs["model"], inputs["scene"], inputs["train"]
    f = Field(m)
    f.check_scope()
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in inputs["weights"].items()}
    opt = nerf.Adam(p)
    dev = sc["images"].device
    gen = torch.Generator(device=dev).manual_seed(tr["gen_seed"])
    B = tr["batch_size"]
    n_img, n_pix = sc["images"].shape[0], sc["directions"].shape[0]
    w = {"opacity": tr["opacity_loss_w"], "cv": tr["cv_loss_w"]}
    if n_steps > 16 or tr["warmup_steps"] < n_steps:
        raise ValueError("the reference follows warm-up steps after the "
                         "first grid update only")
    losses, grad0 = [], None
    with torch.no_grad():
        jit = torch.rand((f.G ** 3, 3), generator=gen, device=dev) * 2 - 1
        sig, _, _ = density_features(p, nerf.cell_points(f, jit), f.scale,
                                     f, prec)
        occ = nerf.warmup_grid(sig, f)
    for step in range(n_steps):
        img = torch.randint(0, n_img, (B,), generator=gen, device=dev)
        pix = torch.randint(0, n_pix, (B,), generator=gen, device=dev)
        jit = torch.rand(B, generator=gen, device=dev)
        if fault == "half_batch":
            img, pix, jit = img[:B // 2], pix[:B // 2], jit[:B // 2]
        o, d = nerf.get_rays(sc["directions"][pix], sc["poses"][img])
        out = forward(p, occ, o, d, jit, gen, f, prec,
                      tr["budget_per_ray"], m["n_experts"])
        lv = loss(out, sc["images"][img, pix], w)
        grads = torch.autograd.grad(lv, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        if grad0 is None:
            grad0 = {k: float(g.norm()) for k, g in grads.items()}
        losses.append(float(lv.detach()))
        opt.step(grads, tr["lr"])
    return {"loss": losses, "grad0": grad0, "occ": occ[None],
            "weights": {k: v.detach() for k, v in p.items()}}


def update_grid(p, grid, gen, f: Field, prec: Prec, decay: float = 0.95):
    """A grid update outside warm-up of the one grid (1, G^3), the
    densities through the clean gate: {"lo", "hi"} -> {"grid", "occ"},
    each (1, G^3) (see nerf.grid_update)."""
    out = nerf.grid_update(
        grid[0], lambda x: density_features(p, x, f.scale, f, prec)[0],
        gen, f, decay)
    return {s: {v: o[v][None] for v in o} for s, o in out.items()}


def flops_per_sample(m: dict) -> float:
    """Multiply-adds a valid sample needs: the gate's two MLPs, its one
    routed expert, the geo and rgb heads."""
    feat = m["n_levels"] * m["n_features"]

    def macs(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))

    gate = [feat] + [m["gate_hidden"]] * m["gate_layers"] + [m["n_experts"]]
    inter = [feat] + [m["inter_hidden"]] * m["inter_layers"] + [feat]
    geo = [feat] + [m["geo_hidden"]] * m["geo_layers"] + [1 + m["geo_out"]]
    rgb = ([m["sh_degree"] ** 2 + m["geo_out"]]
           + [m["rgb_hidden"]] * m["rgb_layers"] + [3])
    return float(2 * macs(gate) + macs(inter) + macs(geo) + macs(rgb))


def flops_per_ray(m: dict) -> float:
    return 0.0
