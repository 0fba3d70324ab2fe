"""Plain PyTorch reference of the Instant-NGP field and its volume render,
as Rad-NeRF trains and renders it, written from the published method and
independent of the program under test: it imports nothing of it.

It computes in float32 (float64 where a position is formed, which rounds
as one fused multiply-add does), with no kernels and no sample buffers:
every function here is a direct statement of what the field, the march
and the compositor compute. `Prec` can round the operands of every
matrix product and encode to float8 (e4m3, one scale per tensor): the
lower-precision control that the comparison must reject.

Scope: one occupancy cascade and a constant step (scene scale <= 0.5,
the configurations this benchmark runs); `check_scope` refuses others.
"""

from __future__ import annotations

import math

import torch

SQRT3 = math.sqrt(3.0)
F8_MAX = 448.0                      # largest finite float8_e4m3fn


class Prec:
    """Where the program rounds to its compute dtype, the reference keeps
    float32 ('f32') or rounds to float8 e4m3 with one scale per tensor
    ('fp8', gradients passed straight through)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        s = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
        r = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (r - x).detach()


# ---------------------------------------------------------------------------
# field configuration
# ---------------------------------------------------------------------------

class Field:
    """The sizes of one Instant-NGP field (the configuration's numbers)."""

    def __init__(self, c: dict):
        self.scale = float(c["scale"])
        self.L = int(c["n_levels"])
        self.F = int(c["n_features"])
        self.log2_T = int(c["log2_hashmap_size"])
        self.T = 1 << self.log2_T
        self.N_min = int(c["base_resolution"])
        self.G = int(c["density_grid_size"])
        self.max_samples = int(c["max_samples"])
        self.samples_per_ray = int(c["samples_per_ray"])
        self.T_threshold = float(c["T_threshold"])
        self.sh_degree = int(c["sh_degree"])
        b = math.exp(math.log(2048.0 * self.scale / self.N_min)
                     / (self.L - 1))
        self.level_scale = [
            float(torch.tensor(self.N_min * b ** lvl - 1.0,
                               dtype=torch.float32))
            for lvl in range(self.L)]
        self.level_res = [int(math.ceil(s)) + 1 for s in self.level_scale]
        self.cascades = max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)
        self.dt = SQRT3 / self.max_samples
        self.k_candidates = min(self.max_samples,
                                int(math.ceil(2 * self.scale
                                              * self.max_samples)) + 1)
        self.density_threshold = 0.01 * self.max_samples / SQRT3

    def check_scope(self) -> None:
        if self.cascades != 1 or self.F != 2 or self.T % 128:
            raise ValueError("the reference covers one cascade (scale <= "
                             "0.5), 2 features and T divisible by 128")


# ---------------------------------------------------------------------------
# rays and the march
# ---------------------------------------------------------------------------

def fma(a, b, c) -> torch.Tensor:
    """float32 round(a * b + c), formed in float64."""
    f = (lambda v: v.double() if isinstance(v, torch.Tensor) else float(
        torch.tensor(v, dtype=torch.float32)))
    return (f(a) * f(b) + f(c)).float()


def get_rays(dirs: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame directions (N, 3) and camera-to-world (N, 3, 4) ->
    origins and directions (not normalised)."""
    d = (dirs[:, 0:1] * c2w[:, :, 0] + dirs[:, 1:2] * c2w[:, :, 1]
         + dirs[:, 2:3] * c2w[:, :, 2])
    return c2w[:, :, 3].contiguous(), d


def near_far(o: torch.Tensor, d: torch.Tensor, half: float,
             near: float = 0.01):
    """Entry and exit of the box [-half, half]^3 (t1 = t2 = -1 on a
    miss; an entry before `near` is moved to it)."""
    inv = 1.0 / d
    t0 = (-half - o) * inv
    t1 = (half - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = tmax > tmin
    tn = torch.where(hit, tmin, -1.0)
    tf = torch.where(hit, tmax, -1.0)
    tn = torch.where((tn >= 0) & (tn < near), near, tn)
    return tn, tf


def occ_cell(xyz: torch.Tensor, f: Field) -> torch.Tensor:
    """Flat cell index of points in the single-cascade grid."""
    G = f.G
    n = torch.clamp(0.5 * (xyz / f.scale + 1.0) * G, 0.0, G - 1.0).long()
    return (n[..., 0] * G + n[..., 1]) * G + n[..., 2]


def lattice(o, d, t1, t2, f: Field, jitter=None):
    """Every ray's candidate samples t_k = t1' + k dt, t1' = t1 jittered by
    jitter * dt: t (N, K), positions (N, K, 3), in-range mask."""
    start = t1 if jitter is None else torch.where(
        t1 >= 0, fma(jitter, f.dt, t1), t1)
    k = torch.arange(f.k_candidates, device=o.device, dtype=torch.float32)
    t = fma(k[None, :], f.dt, start[:, None])
    inside = (start[:, None] >= 0) & (t >= 0) & (t < t2[:, None])
    xyz = fma(t[..., None], d[:, None, :], o[:, None, :])
    return t, xyz, inside


def march_budget(keep: torch.Tensor, t: torch.Tensor, per_ray_cap: int,
                 budget: int):
    """The training march's sample choice: each ray keeps its first
    min(kept, per_ray_cap) candidates; when the rays want more than
    `budget` samples in all, ray r keeps max(1, floor(n_r * budget /
    total)) of them, and rays laid out one after another past the budget
    lose their tail. Returns, in ray order, the chosen samples' ray ids
    and t, and each ray's first slot and count; slot j of the
    `budget`-long layout holds sample j."""
    N = keep.shape[0]
    dev = keep.device
    n_r = keep.sum(1).clamp_max(per_ray_cap)
    total = int(n_r.sum())
    if total <= budget:
        cap = n_r
    else:
        ratio = (torch.tensor(float(budget), device=dev)
                 / torch.tensor(float(total), device=dev))
        cap = torch.minimum(
            n_r, torch.floor(n_r.float() * ratio).long().clamp_min(1))
    first = torch.cumsum(cap, 0) - cap
    count = (torch.minimum(first + cap, torch.tensor(budget, device=dev))
             - first).clamp(min=0)
    rank = torch.cumsum(keep.long(), 1) - 1
    chosen = keep & (rank < count[:, None])
    rid = torch.arange(N, device=dev)[:, None].expand_as(keep)[chosen]
    return rid, t[chosen], first, count


def slot_ray_ids(first: torch.Tensor, budget: int, N: int) -> torch.Tensor:
    """The ray of each of `budget` slots: the last ray whose first slot is
    at or before it (clamped to the rays), so the empty tail of the
    layout belongs to the last ray."""
    starts = torch.zeros(budget + 1, dtype=torch.long, device=first.device)
    starts.index_add_(0, first.clamp_max(budget), torch.ones_like(first))
    return (torch.cumsum(starts[:budget], 0) - 1).clamp(0, N - 1)


# ---------------------------------------------------------------------------
# the hash encoding (Instant-NGP, cube-brick table layout)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _brick_row(level: int, np_: int, dense: bool, px, py, pz, R: int):
    """The table row of a 4x4x4-cell patch: patch-major below R rows,
    else a mixed hash of the patch coordinates salted by the level."""
    if dense:
        return (px + np_ * (py + np_ * pz)) & (R - 1)
    h = (_mul32(px & _M32, 2654435761) ^ _mul32(py & _M32, 805459861)
         ^ _mul32(pz & _M32, 3674653429))
    h = (h + ((0x9E3779B9 * (level + 1)) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h & (R - 1)


def corners(xn: torch.Tensor, f: Field, level: int):
    """Flat table entries (8, N) and trilinear weights (8, N) of points
    xn in [0, 1]^3 at one level. A row holds a 5x5x5 block of lattice
    points, lane x + 5 y + 25 z within the patch, so the 8 corners of a
    cell share one row."""
    R = f.T // 128
    pos = fma(xn, f.level_scale[level], 0.5)
    pi = torch.floor(pos)
    frac = pos - pi
    pi = pi.long()
    p = torch.div(pi, 4, rounding_mode="floor")
    lane0 = ((pi[:, 0] - 4 * p[:, 0]) + 5 * (pi[:, 1] - 4 * p[:, 1])
             + 25 * (pi[:, 2] - 4 * p[:, 2]))
    np_ = f.level_res[level] // 4 + 1
    row = _brick_row(level, np_, np_ ** 3 <= R, p[:, 0], p[:, 1], p[:, 2],
                     R)
    base = level * f.T + row * 128 + lane0
    idx, wts = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx.append(base + dx + 5 * dy + 25 * dz)
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                wts.append(w)
    return torch.stack(idx), torch.stack(wts)


def encode(table: torch.Tensor, x: torch.Tensor, box: float, f: Field,
           prec: Prec) -> torch.Tensor:
    """Hash features (N, L * 2), level-major, of world points x (N, 3) in
    the box [-box, box]^3; differentiable in the table."""
    xn = ((x + box) / (2 * box)).clamp(0.0, 1.0)
    flat = prec.q(table).reshape(-1, 2)
    out = []
    for level in range(f.L):
        idx, w = corners(xn, f, level)
        out.append((flat[idx] * w[..., None]).sum(0))      # (N, 2)
    return prec.q(torch.cat(out, dim=1))


def sh(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 of the unit directions (16
    values), in the tcnn sign convention."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], dim=-1)


class _TruncExp(torch.autograd.Function):
    """exp, whose gradient takes exp of the input clamped to [-15, 15]
    (Instant-NGP's density activation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def mlp(ws: list, bs: list, x: torch.Tensor, prec: Prec,
        out_act: str | None = None) -> torch.Tensor:
    """ReLU MLP, each layer x @ w + b; stacked weights (K, in, out) give
    (K, N, out)."""
    h = prec.q(x)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = prec.q(torch.matmul(h, prec.q(w))) + b.unsqueeze(-2)
        if i < len(ws) - 1:
            h = prec.q(torch.relu(h))
    if out_act == "sigmoid":
        h = torch.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------

def composite(sigma: torch.Tensor, rgb: torch.Tensor, t: torch.Tensor,
              rid: torch.Tensor, N: int, f: Field, bg: float = 1.0):
    """Volume rendering of samples in ray order: sigma (E, S), rgb
    (E, S, 3), t (S,), rid (S,) sorted. alpha = 1 - exp(-sigma dt), T the
    transmittance before a sample; a sample whose T has fallen to the
    threshold adds nothing. Returns opacity (E, N), depth (E, N), rgb
    (E, N, 3) over a background `bg`, and the weights (E, S)."""
    E = sigma.shape[0]
    sd = sigma * f.dt
    cs = torch.cumsum(sd.double(), dim=1)
    start = torch.ones_like(rid, dtype=torch.bool)
    if rid.numel():
        start[1:] = rid[1:] != rid[:-1]
    pos = torch.arange(rid.numel(), device=rid.device)
    seg0 = torch.cummax(torch.where(start, pos, 0), 0).values
    before = torch.where((seg0 > 0)[None], cs[:, (seg0 - 1).clamp_min(0)],
                         0.0)
    excl = (cs - before).float() - sd
    T = torch.exp(-excl)
    w = (1.0 - torch.exp(-sd)) * T * (T > f.T_threshold)
    opacity = torch.zeros(E, N, device=sd.device).index_add(1, rid, w)
    depth = torch.zeros(E, N, device=sd.device).index_add(1, rid, w * t)
    col = torch.zeros(E, N, 3, device=sd.device).index_add(
        1, rid, w[..., None] * rgb)
    col = col + bg * (1.0 - opacity[..., None])
    return opacity, depth, col, w


# ---------------------------------------------------------------------------
# the optimizer and the density grid
# ---------------------------------------------------------------------------

class Adam:
    """Adam with bias correction, as Instant-NGP trains (eps 1e-15), on a
    dict of leaves."""

    def __init__(self, params: dict, eps: float = 1e-15,
                 betas=(0.9, 0.999)):
        self.p = params
        self.eps, (self.b1, self.b2) = eps, betas
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.n += 1
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            self.p[k].sub_(lr * (self.m[k] / c1) / denom)


def grid_cells(f: Field, device):
    """Every cell's integer coordinates (G^3, 3), flat index x G^2 + y G +
    z."""
    r = torch.arange(f.G, device=device)
    xx, yy, zz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(-1, 3)


def cell_points(f: Field, jitter: torch.Tensor) -> torch.Tensor:
    """A point in every cell of the single-cascade grid, jittered by
    jitter (G^3, 3) in [-1, 1) times half a cell."""
    return points_in_cells(f, grid_cells(f, jitter.device), jitter)


def points_in_cells(f: Field, c: torch.Tensor, jitter: torch.Tensor):
    """A point in each cell of integer coordinates c (n, 3), jittered by
    jitter (n, 3) in [-1, 1) times half a cell."""
    s = min(0.5, f.scale)
    half = s / f.G
    return (c.float() / (f.G - 1) * 2.0 - 1.0) * (s - half) + jitter * half


def warmup_grid(density: torch.Tensor, f: Field) -> torch.Tensor:
    """The occupancy after the first (warm-up) grid update, from the
    densities of every cell: the grid starts at zero, and a cell is
    occupied above min(mean density of positive cells, threshold)."""
    return _occupancy(density.clamp_min(0.0), f)


def _occupancy(grid: torch.Tensor, f: Field) -> torch.Tensor:
    pos = grid > 0
    mean = torch.where(pos, grid, 0.0).sum() / pos.sum().clamp_min(1)
    return grid > torch.clamp_max(mean, f.density_threshold)


@torch.no_grad()
def grid_update(grid: torch.Tensor, density, gen: torch.Generator,
                f: Field, decay: float = 0.95) -> dict:
    """One update of a grid (G^3,) outside warm-up: G^3/4 cells drawn
    uniformly and G^3/4 drawn with replacement among the cells above the
    threshold (uniformly again where there is none), in that order from
    `gen`, each at a point jittered from `gen`. A cell keeps the larger
    of its decayed value and its new density; a negative cell stays.

    A cell drawn twice takes the density of one of its draws, and which
    one is not fixed; so the result is given for the smallest ("lo") and
    the largest ("hi") of them: each grid and its occupancy."""
    n, dev = f.G ** 3, grid.device
    m = n // 4
    occupied = torch.nonzero(grid > f.density_threshold).flatten()
    total = max(occupied.numel(), 1)
    uniform = torch.randint(0, n, (m,), generator=gen, device=dev)
    rank = (torch.rand(m, generator=gen, device=dev) * total).long()
    fallback = torch.randint(0, n, (m,), generator=gen, device=dev)
    drawn = (occupied[rank.clamp_max(total - 1)] if occupied.numel()
             else fallback)
    cells = torch.cat([uniform, drawn])
    ijk = torch.stack([cells // (f.G * f.G), cells // f.G % f.G,
                       cells % f.G], -1)
    jitter = torch.rand((2 * m, 3), generator=gen, device=dev) * 2.0 - 1.0
    sig = density(points_in_cells(f, ijk, jitter)).float()
    out = {}
    for side, how in (("lo", "amin"), ("hi", "amax")):
        new = torch.zeros(n, device=dev).scatter_reduce(
            0, cells, sig, how, include_self=False)
        new = torch.where(grid < 0, grid, torch.maximum(grid * decay, new))
        out[side] = {"grid": new, "occ": _occupancy(new, f)}
    return out
