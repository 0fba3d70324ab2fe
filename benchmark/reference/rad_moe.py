"""Plain reference of Rad-NeRF's mixture of experts (a ray gate over K
Instant-NGP experts that share one hash table; union sampling: one march
against the union of the experts' occupancy grids, each expert's density
masked to its own grid), its training steps and its test-time render.

Leaves are named by path as the program's parameter tree is ("model/
hash_table", "model/geo/w/0", "gate/encoder/w/0", ...); the random draws
(the grid update's jitter, the batch, the start jitter) are taken from a
generator seeded as the program's, in the same order and shapes.
"""

from __future__ import annotations

import torch

from . import nerf
from .nerf import Field, Prec


def param_spec(m: dict) -> list:
    """[(path, shape, init, arg)] of the MoE's weights: the hash table
    (U(-a, a), a = table_init; tcnn's init is 1e-4), the experts' stacked
    geo and rgb MLPs and the ray gate (He-uniform; zero biases but the
    density output's, sigma_bias)."""
    K, L, T = m["n_experts"], m["n_levels"], 1 << m["log2_hashmap_size"]
    feat = L * m["n_features"]
    spec = [("model/hash_table", (L, T, 2), "uniform", m["table_init"])]

    def stack(name, dims, lead):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            spec.append((f"{name}/w/{i}", lead + (a, b), "he", 1.0))
            last_geo = name == "model/geo" and i == len(dims) - 2
            spec.append((f"{name}/b/{i}", lead + (b,), "first",
                         m.get("sigma_bias", 0.0) if last_geo else 0.0))

    geo = [feat] + [m["geo_hidden"]] * m["geo_layers"] + [1 + m["geo_out"]]
    rgb = ([m["sh_degree"] ** 2 + m["geo_out"]]
           + [m["rgb_hidden"]] * m["rgb_layers"] + [3])
    gate = [6] + [m["gate_hidden"]] * m["gate_layers"] + [K]
    stack("model/geo", geo, (K,))
    stack("model/rgb", rgb, (K,))
    stack("gate/encoder", gate, ())
    return spec


def _layers(p: dict, name: str):
    n = sum(1 for k in p if k.startswith(f"{name}/w/"))
    return ([p[f"{name}/w/{i}"] for i in range(n)],
            [p[f"{name}/b/{i}"] for i in range(n)])


def _expert_density(p, x, box, f: Field, prec: Prec, k: int):
    ws, bs = _layers(p, "model/geo")
    feat = nerf.encode(p["model/hash_table"], x, box, f, prec)
    h = nerf.mlp([w[k] for w in ws], [b[k] for b in bs], feat, prec)
    return torch.exp(h[:, 0])


def field(p, x, d_sh, rid, box, f: Field, prec: Prec):
    """Every expert on the union samples x (S, 3): densities (K, S) and
    colours (K, S, 3); d_sh (N, 16) the rays' direction encoding."""
    geo_w, geo_b = _layers(p, "model/geo")
    rgb_w, rgb_b = _layers(p, "model/rgb")
    feat = nerf.encode(p["model/hash_table"], x, box, f, prec)
    h = nerf.mlp(geo_w, geo_b, feat, prec)                  # (K, S, 17)
    K = h.shape[0]
    rgb_in = torch.cat([prec.q(d_sh)[rid][None].expand(K, -1, -1),
                        h[..., 1:]], -1)
    rgbs = nerf.mlp(rgb_w, rgb_b, rgb_in, prec, out_act="sigmoid")
    return nerf.trunc_exp(h[..., 0]), rgbs


def gate(p, o, d, prec: Prec):
    ws, bs = _layers(p, "gate/encoder")
    logits = nerf.mlp(ws, bs, torch.cat([o, d], 1), prec)
    return torch.softmax(logits, dim=1)


def forward(p: dict, occ: torch.Tensor, o, d, jitter, f: Field, m: dict,
            prec: Prec, budget_per_ray: int):
    """The training render of rays (o, d) with start jitter: rgb (N, 3),
    opacity (N,), depth (N, K), gate (N, K)."""
    N, K = o.shape[0], occ.shape[0]
    box = f.scale
    t1, t2 = nerf.near_far(o, d, box)
    t, xyz, inside = nerf.lattice(o, d, t1, t2, f, jitter)
    keep = inside & occ.any(0)[nerf.occ_cell(xyz, f)]
    del xyz
    rid, ts, _, _ = nerf.march_budget(keep, t, f.samples_per_ray * K,
                                      N * budget_per_ray)
    x = nerf.fma(ts[:, None], d[rid], o[rid])
    member = occ[:, nerf.occ_cell(x, f)]                   # (K, S)
    sig, rgbs = field(p, x, nerf.sh(d), rid, box, f, prec)
    sig = torch.where(member, sig, 0.0)
    opac, depth, col, _ = nerf.composite(sig, rgbs, ts, rid, N, f)
    g = gate(p, o, d, prec)
    return {"rgb": torch.einsum("nk,knc->nc", g, col),
            "opacity": torch.einsum("nk,kn->n", g, opac),
            "depth": depth.T, "gate": g}


def loss(out: dict, target: torch.Tensor, w: dict) -> torch.Tensor:
    """Rad-NeRF's loss: colour MSE, the opacity entropy, the gate's
    load-balancing cv^2 and the depth-mutual term (each a mean)."""
    total = ((out["rgb"] - target) ** 2).mean()
    o = out["opacity"] + 1e-10
    total = total + w["opacity"] * (-o * torch.log(o)).mean()
    g = out["gate"]
    imp = g.sum(0)
    cv = imp.var(unbiased=False) / (imp.mean() ** 2 + 1e-10)
    total = total + w["cv"] * cv
    cons = (out["depth"] * g).sum(1, keepdim=True).detach()
    return total + w["depth_mutual"] * ((out["depth"] - cons) ** 2).mean()


def update_grid_warmup(p, gen, f: Field, K: int, prec: Prec):
    """The first grid update: every cell of each expert's grid, at a
    point jittered from the generator (expert by expert)."""
    occ = []
    with torch.no_grad():
        for k in range(K):
            jit = torch.rand((f.G ** 3, 3), generator=gen,
                             device=p["model/hash_table"].device) * 2.0 - 1.0
            sig = _expert_density(p, nerf.cell_points(f, jit), f.scale, f,
                                  prec, k)
            occ.append(nerf.warmup_grid(sig, f))
    return torch.stack(occ)


def update_grid(p, grid, gen, f: Field, prec: Prec, decay: float = 0.95):
    """A grid update outside warm-up of each expert's grid (K, G^3),
    expert by expert from one generator: {"lo", "hi"} -> {"grid",
    "occ"}, each (K, G^3) (see nerf.grid_update)."""
    sides = [nerf.grid_update(
        grid[k], lambda x, k=k: _expert_density(p, x, f.scale, f, prec, k),
        gen, f, decay) for k in range(grid.shape[0])]
    return {s: {v: torch.stack([o[s][v] for o in sides])
                for v in ("grid", "occ")} for s in ("lo", "hi")}


def union_budget(tr: dict, K: int) -> int:
    """Samples a ray in the union stream's budget: the budget itself
    under the adaptive budget (its buckets count the union), else K times
    it (each expert's share)."""
    return tr["budget_per_ray"] * (1 if tr.get("adaptive_budget", True)
                                   else K)


def train(inputs: dict, n_steps: int, prec: Prec, fault: str | None = None):
    """The first `n_steps` training steps from the initial weights:
    each step's loss, the first step's gradient norm per leaf, the
    weights after the last step and the occupancy (K, G^3) of the first
    grid update, which the steps march. `fault` "half_batch" takes the
    loss over the first half of each batch (a planted fault)."""
    m, sc, tr = inputs["model"], inputs["scene"], inputs["train"]
    f = Field(m)
    f.check_scope()
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in inputs["weights"].items()}
    opt = nerf.Adam(p)
    dev = sc["images"].device
    gen = torch.Generator(device=dev).manual_seed(tr["gen_seed"])
    K, B = m["n_experts"], tr["batch_size"]
    n_img, n_pix = sc["images"].shape[0], sc["directions"].shape[0]
    w = {"opacity": tr["opacity_loss_w"], "cv": tr["cv_loss_w"],
         "depth_mutual": tr["depth_mutual_loss_w"]}
    if n_steps > 16 or tr["warmup_steps"] < n_steps:
        raise ValueError("the reference follows warm-up steps after the "
                         "first grid update only")
    losses, grad0 = [], None
    occ = update_grid_warmup(p, gen, f, K, prec)
    for step in range(n_steps):
        img = torch.randint(0, n_img, (B,), generator=gen, device=dev)
        pix = torch.randint(0, n_pix, (B,), generator=gen, device=dev)
        jit = torch.rand(B, generator=gen, device=dev)
        if fault == "half_batch":
            img, pix, jit = img[:B // 2], pix[:B // 2], jit[:B // 2]
        o, d = nerf.get_rays(sc["directions"][pix], sc["poses"][img])
        out = forward(p, occ, o, d, jit, f, m, prec, union_budget(tr, K))
        lv = loss(out, sc["images"][img, pix], w)
        grads = torch.autograd.grad(lv, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        if grad0 is None:
            grad0 = {k: float(g.norm()) for k, g in grads.items()}
        losses.append(float(lv.detach()))
        opt.step(grads, tr["lr"])
    return {"loss": losses, "grad0": grad0, "occ": occ,
            "weights": {k: v.detach() for k, v in p.items()}}


@torch.no_grad()
def render(inputs: dict, o: torch.Tensor, d: torch.Tensor, prec: Prec,
           occ: torch.Tensor, block: int = 4096) -> dict:
    """The test-time render of rays (o, d) from the initial weights and
    the given occupancy (K, G^3): every kept candidate from the entry on,
    composited until the transmittance falls to the threshold; rgb (N, 3)
    over a white background, opacity (N,) and the gate's depth (N,)."""
    m = inputs["model"]
    f = Field(m)
    f.check_scope()
    p = inputs["weights"]
    outs = []
    for a in range(0, o.shape[0], block):
        ob, db = o[a:a + block], d[a:a + block]
        n = ob.shape[0]
        t1, t2 = nerf.near_far(ob, db, f.scale)
        t, xyz, inside = nerf.lattice(ob, db, t1, t2, f)
        keep = inside & occ.any(0)[nerf.occ_cell(xyz, f)]
        rid = torch.arange(n, device=o.device)[:, None].expand_as(keep)[keep]
        ts = t[keep]
        x = nerf.fma(ts[:, None], db[rid], ob[rid])
        member = occ[:, nerf.occ_cell(x, f)]
        sig, rgbs = field(p, x, nerf.sh(db), rid, f.scale, f, prec)
        sig = torch.where(member, sig, 0.0)
        opac, depth, col, _ = nerf.composite(sig, rgbs, ts, rid, n, f)
        g = gate(p, ob, db, prec)
        outs.append({"rgb": torch.einsum("nk,knc->nc", g, col),
                     "opacity": torch.einsum("nk,kn->n", g, opac),
                     "depth": (depth.T * g).sum(1)})
    return {k: torch.cat([b[k] for b in outs]) for k in outs[0]}


def flops_per_sample(m: dict) -> float:
    """Multiply-adds of the experts' MLPs on one union sample (union
    sampling runs every expert on it)."""
    feat = m["n_levels"] * m["n_features"]
    geo = [feat] + [m["geo_hidden"]] * m["geo_layers"] + [1 + m["geo_out"]]
    rgb = ([m["sh_degree"] ** 2 + m["geo_out"]]
           + [m["rgb_hidden"]] * m["rgb_layers"] + [3])
    return float(m["n_experts"] * (
        sum(a * b for a, b in zip(geo[:-1], geo[1:]))
        + sum(a * b for a, b in zip(rgb[:-1], rgb[1:]))))


def flops_per_ray(m: dict) -> float:
    """Multiply-adds of the ray gate on one ray."""
    gate_d = [6] + [m["gate_hidden"]] * m["gate_layers"] + [m["n_experts"]]
    return float(sum(a * b for a, b in zip(gate_d[:-1], gate_d[1:])))

