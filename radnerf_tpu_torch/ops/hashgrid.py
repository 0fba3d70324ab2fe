"""Multiresolution hash-grid encoding (twin of radnerf_tpu/ops/hashgrid.py;
Instant-NGP / tcnn semantics):

  scale_l = N_min * b**l - 1,  res_l = ceil(scale_l) + 1,
  pos = x * scale_l + 0.5 for x in [0, 1]^3, trilinear over floor(pos),
  row = x + y res + z res^2               if res^3 <= T (dense)
      = x * 1 ^ y * 2654435761 ^ z * 805459861   otherwise (hashed),
  row &= T - 1, out = the levels' interpolated features, (N, L*F).

The tcnn-hash encode (`hashgrid_encode`) is a plain gather here: the
reference's forwards are XLA gathers outside any Pallas kernel. Its
backward, and every other family's, is a table-gradient CUDA kernel
(`ops/stream_table_grad.py`, `ops/hashgrid_brick3.py`).
`encode_dispatch` routes `hash_impl` to the six families: the tcnn hash
('xla', 'sort', 'window', 'dedup', 'pallas'), 'slab', 'brick' and
'brick3'; the last three are bfloat16-only and fall back to 'dedup'.
Every family's table gradient is the exact f32 gradient.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from .fma import fma32


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static configuration of the hash-grid encoder (reference field:
    L=16, F=2, log2_T=19, N_min=16)."""

    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819128800

    @staticmethod
    def for_scene_scale(
        scale: float,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_resolution: int = 16,
        max_resolution_mult: float = 2048.0,
    ) -> "HashGridConfig":
        """b chosen so the finest level reaches 2048 * scale."""
        b = math.exp(
            math.log(max_resolution_mult * scale / base_resolution)
            / (n_levels - 1)
        )
        return HashGridConfig(
            n_levels=n_levels,
            n_features=n_features,
            log2_table_size=log2_table_size,
            base_resolution=base_resolution,
            per_level_scale=b,
        )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        l = np.arange(self.n_levels)
        return (
            self.base_resolution * self.per_level_scale**l - 1.0
        ).astype(np.float32)

    def level_resolutions(self) -> np.ndarray:
        return (np.ceil(self.level_scales()) + 1).astype(np.int64)

    def level_is_dense(self) -> np.ndarray:
        res = self.level_resolutions()
        return (res**3) <= self.table_size


def init_hashgrid_table(
    gen: torch.Generator,
    cfg: HashGridConfig,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """tcnn's default init: (L, T, F) uniform in [-1e-4, 1e-4]."""
    shape = (cfg.n_levels, cfg.table_size, cfg.n_features)
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return (u * 2e-4 - 1e-4).to(device)


# Spatial hash primes (Instant-NGP paper, table 1; tcnn fast_hash).
_PRIMES = (1, 2654435761, 805459861)
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    the constant is split into 16-bit halves (each product < 2^48)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _geometry(x: torch.Tensor, cfg: HashGridConfig, levels):
    """floor coords (3 x (G, N) int32) + frac ((G, 3, N) f32), with
    pos = fma(x, scale, 0.5) as in the jitted reference."""
    scales = torch.as_tensor(cfg.level_scales()[list(levels)],
                             device=x.device)
    pos = fma32(x.T[None, :, :], scales[:, None, None], 0.5)
    pos_i = torch.floor(pos)
    frac = pos - pos_i
    pos_i = pos_i.to(torch.int32)
    return pos_i[:, 0], pos_i[:, 1], pos_i[:, 2], frac


def _tcnn_rows(cx, cy, cz, res, dense, T: int) -> torch.Tensor:
    """Table rows (int64) of int64 corner coords: the dense index or the
    xor-multiply hash, masked to T - 1. The u32 arithmetic of the
    reference is done in int64 (no product reaches 2^63), and masking to
    the low log2(T) bits gives the same rows as wrapping at 2^32."""
    idx_dense = cx + res * (cy + res * cz)
    idx_hash = cx * _PRIMES[0] ^ cy * _PRIMES[1] ^ cz * _PRIMES[2]
    return torch.where(dense, idx_dense, idx_hash) & (T - 1)


def _corner_bits(device):
    """(x, y, z) offsets of the 8 corners, c = x + 2 y + 4 z, each
    (1, 8, 1) int64."""
    c = torch.arange(8, device=device)
    return [((c >> d) & 1)[None, :, None] for d in range(3)]


def _trilinear_weights(frac: torch.Tensor) -> torch.Tensor:
    """(G, 3, N) fractions -> (G, 8, N) f32 corner weights (w_x w_y) w_z,
    the reference's product order."""
    w = None
    for d, b in enumerate(_corner_bits(frac.device)):
        f = frac[:, d, None, :]
        sel = torch.where(b == 1, f, 1.0 - f)
        w = sel if w is None else w * sel
    return w


def hashgrid_indices_cm(x: torch.Tensor, cfg: HashGridConfig):
    """Corner-major table rows and trilinear weights of (N, 3) positions:
    (L, 8, N) int32 and (L, 8, N) f32, corner c = x + 2 y + 4 z."""
    L, T = cfg.n_levels, cfg.table_size
    dev = x.device
    xi, yi, zi, frac = _geometry(x, cfg, range(L))
    cx, cy, cz = (p.to(torch.int64)[:, None, :] + b
                  for p, b in zip((xi, yi, zi), _corner_bits(dev)))
    res = torch.as_tensor(cfg.level_resolutions(), device=dev)[:, None, None]
    dense = torch.as_tensor(cfg.level_is_dense(), device=dev)[:, None, None]
    idx = _tcnn_rows(cx, cy, cz, res, dense, T).to(torch.int32)
    return idx, _trilinear_weights(frac)


def hashgrid_indices(x: torch.Tensor, cfg: HashGridConfig):
    """Point-major rows and weights: (L, N, 8) int32 and (L, N, 8) f32
    (the reference's `jnp.prod` over the three factors, in the same
    (w_x w_y) w_z order)."""
    idx, w = hashgrid_indices_cm(x, cfg)
    return idx.transpose(1, 2), w.transpose(1, 2)


def _flat_level_idx(idx: torch.Tensor, T: int) -> torch.Tensor:
    """(L, ...) per-level rows -> int64 rows into the stacked (L*T) table,
    same shape."""
    L = idx.shape[0]
    lvl = torch.arange(L, device=idx.device).reshape((L,) + (1,) * (
        idx.dim() - 1))
    return lvl * T + idx.to(torch.int64)


def _cm_out(o0: torch.Tensor, o1: torch.Tensor) -> torch.Tensor:
    """(L, N) per-feature sums -> (N, L*F) level-major tcnn layout."""
    L, N = o0.shape
    return torch.stack([o0, o1], dim=1).permute(2, 0, 1).reshape(N, L * 2)


def _encode_rows(table: torch.Tensor, flat: torch.Tensor, w: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """Interpolate the (L, T, 2) table at flat (L*T) rows (L, 8, N) with
    f32 weights (L, 8, N): weights and features in `compute_dtype`, the 8
    products summed in corner order. In bfloat16 the products of two bf16
    values are exact in f32 and the sum is rounded to bf16 once, as
    jitted XLA evaluates `sum(w_bf16 * f_bf16)`. Returns (N, L*2)."""
    L, _, N = flat.shape
    f = table.to(compute_dtype).reshape(-1, 2)[flat]          # (L, 8, N, 2)
    wc = w.to(compute_dtype)[..., None]
    if compute_dtype == torch.bfloat16:
        p = wc.to(torch.float32) * f.to(torch.float32)
    else:
        p = wc * f
    acc = p[:, 0]
    for c in range(1, 8):
        acc = acc + p[:, c]
    return acc.to(compute_dtype).permute(1, 0, 2).reshape(N, L * 2)


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """tcnn-hash encode of (N, 3) positions in [0, 1]^3 through the
    (L, T, 2) table: (N, L*2) features in `compute_dtype`, level-major.
    A plain gather; autograd differentiates it as the reference's
    autodiff does (the encode_dispatch families supply their own
    backward)."""
    idx, w = hashgrid_indices_cm(x, cfg)
    return _encode_rows(table, _flat_level_idx(idx, cfg.table_size), w,
                        compute_dtype)


def hashgrid_encode_packed(table: torch.Tensor, x: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """The bf16 encode. The reference gathers bf16x2 words to halve its
    gather issues; the values, and so the output, are those of
    `hashgrid_encode(..., bfloat16)`."""
    return hashgrid_encode(table, x, cfg, torch.bfloat16)


class _TableGradEncode(torch.autograd.Function):
    """An encode whose backward is a table-gradient function: forward
    `fwd(table, x)`, backward `table_grad(x, g)` with g the f32 output
    gradient, giving (L, T, 2) f32. No gradient reaches x, as in every
    reference family with a custom backward (they return zeros for the
    positions)."""

    @staticmethod
    def forward(ctx, table, x, fwd, table_grad):
        ctx.table_grad = table_grad
        ctx.save_for_backward(x)
        return fwd(table, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dtable = ctx.table_grad(x, g.to(torch.float32).contiguous())
        return dtable, None, None, None


def table_grad_encode(table, x, fwd, table_grad) -> torch.Tensor:
    """Differentiable encode from a forward and a table gradient (see
    _TableGradEncode)."""
    return _TableGradEncode.apply(table, x.detach(), fwd, table_grad)


def resolve_impl(impl: str) -> str:
    """'auto' -> 'brick3', the reference's choice on an accelerator (the
    port always runs on one; the reference's CPU rule, 'xla', does not
    apply)."""
    return "brick3" if impl == "auto" else impl


def hash_family(impl: str) -> str:
    """Table layout / spatial hash family of an encode impl: tables
    trained under one family decode as garbage under another."""
    r = resolve_impl(impl)
    if r in ("slab", "slab_plain"):
        return "slab"
    if r == "brick":
        return "brick"
    if r in ("brick3", "brick3_plain"):
        return "brick3"
    return "tcnn"


def incoherent_impl(impl: str) -> str:
    """The impl for spatially incoherent point sets (density-grid
    updates): the plain-forward variant of the same table layout."""
    r = resolve_impl(impl)
    return {
        "dedup": "window",
        "slab": "slab_plain",
        "brick3": "brick3_plain",
    }.get(r, r)


def uses_brick3(impl: str, compute_dtype) -> bool:
    """Whether `encode_dispatch` runs the brick3 encode (which can take a
    table packed once by pack_brick3_table)."""
    return (hash_family(impl) == "brick3"
            and compute_dtype == torch.bfloat16)


def encode_dispatch(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig, compute_dtype=torch.float32,
                    impl: str = "auto",
                    packed: torch.Tensor | None = None) -> torch.Tensor:
    """The differentiable encode of `impl` (see the module docstring):
    brick3, brick and slab in bfloat16, else the tcnn hash; 'xla' takes
    the tcnn scatter kernel as its table backward like 'window', and is
    the one family whose positions get a gradient (see
    hashgrid_encode_xla). `packed` is a brick3 table packed once by the
    caller (brick3 only)."""
    impl = resolve_impl(impl)
    bf16 = compute_dtype == torch.bfloat16
    if impl in ("brick3", "brick3_plain"):
        if bf16:
            from .hashgrid_brick3 import hashgrid_encode_brick3

            return hashgrid_encode_brick3(
                table, x, cfg,
                fw_mode="plain" if impl == "brick3_plain" else "runs",
                packed=packed)
        impl = "dedup"
    if impl == "brick":
        if bf16:
            from .hashgrid_brick import hashgrid_encode_brick

            return hashgrid_encode_brick(table, x, cfg, compute_dtype)
        impl = "dedup"
    if impl in ("slab", "slab_plain"):
        if bf16:
            from .hashgrid_slab import hashgrid_encode_slab

            return hashgrid_encode_slab(
                table, x, cfg, compute_dtype,
                fw_mode="plain" if impl == "slab_plain" else "dedup")
        impl = "dedup"
    if impl == "dedup":
        from .hashgrid_dedup import hashgrid_encode_dedup

        return hashgrid_encode_dedup(table, x, cfg, compute_dtype)
    if impl == "window":
        from .hashgrid_window import hashgrid_encode_window

        return hashgrid_encode_window(table, x, cfg, compute_dtype)
    if impl == "xla":
        from .hashgrid_window import hashgrid_encode_xla

        return hashgrid_encode_xla(table, x, cfg, compute_dtype)
    if impl == "sort":
        from .hashgrid_sort import hashgrid_encode_sort

        return hashgrid_encode_sort(table, x, cfg, compute_dtype)
    if impl == "pallas":
        from .hashgrid_pallas import hashgrid_encode_fused

        return hashgrid_encode_fused(table, x, cfg, compute_dtype)
    raise ValueError(f"unknown hash_impl {impl!r}")
