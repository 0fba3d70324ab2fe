"""Morton (Z-order) encode and decode, and occupancy-bitfield packing
(twin of radnerf_tpu/ops/morton.py, the reference's vren.morton3D,
morton3D_invert and packbits).

Integer bit arithmetic on tensors, in int64 with 32-bit masks (torch has
no uint32 arithmetic on every device): the values equal the reference's
uint32 ones. The port, like the reference, keeps its occupancy grids in
linear (c, x, y, z) order; these functions exist for parity with the
reference's API and for interchange with Morton-ordered grids.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Two zero bits after each of the low 10 bits of v, as uint32."""
    v = v.to(torch.int64) & _U32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) as int32 bit patterns."""
    v = v & _U32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer coords, each in [0, 1024) -> (...,) int32 Morton
    indices."""
    xx = _expand_bits(coords[..., 0])
    yy = _expand_bits(coords[..., 1])
    zz = _expand_bits(coords[..., 2])
    return _to_int32(xx | (yy << 1) | (zz << 2))


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """Inverse of morton3d: (...,) integer indices -> (..., 3) int32
    coords."""
    idx = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(idx >> s) for s in (0, 1, 2)],
                       dim=-1).to(torch.int32)


def packbits(density_grid: torch.Tensor, density_threshold) -> torch.Tensor:
    """(..., M) float grid, M divisible by 8 -> (..., M // 8) uint8
    bitfield: bitfield[n] = OR_i (grid[8n + i] > threshold) << i."""
    occ = (density_grid > density_threshold).to(torch.int32)
    occ = occ.reshape(*density_grid.shape[:-1], -1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=occ.device)
    return (occ << shifts).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """Inverse of packbits, to a boolean occupancy (..., 8 M')."""
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    bits = (bitfield.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*bitfield.shape[:-1], -1).to(torch.bool)
