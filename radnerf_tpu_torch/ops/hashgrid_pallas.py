"""The point-major tcnn-hash table gradient (twin of
radnerf_tpu/ops/hashgrid_pallas.py).

The reference's round-1 Pallas kernel applies each (row, w g) update as
a two-hot row add in VMEM, serially. Its (L, N, 8) point-major stream,
flattened, is an (L, 8N) update stream, so the port hands it to the same
atomic scatter kernel as the corner-major path (`tcnn_table_grad`,
`ops/stream_table_grad.py`).
"""

from __future__ import annotations

import torch

from .hashgrid import (
    HashGridConfig, hashgrid_encode, hashgrid_indices, table_grad_encode,
)
from .stream_table_grad import stream_table_grad


def point_stream(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The update stream of point-major corners: (L, N, 8) rows and
    weights and the (N, L*2) output gradient -> keys (L, 8N) int32 and
    values w * g (2, L, 8N) f32, feature-major."""
    L, N, _ = idx.shape
    g_lvl = g.reshape(N, L, 2).permute(2, 1, 0).to(torch.float32)  # (2,L,N)
    vals = w.to(torch.float32)[None] * g_lvl[..., None]            # (2,L,N,8)
    return (idx.reshape(L, 8 * N).to(torch.int32).contiguous(),
            vals.reshape(2, L, 8 * N).contiguous())


def hashgrid_table_grad(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        cfg: HashGridConfig, tile: int = 512,
                        n_chains: int = 3) -> torch.Tensor:
    """dL/dtable from point-major corners: idx (L, N, 8) int32 rows, w
    (L, N, 8) weights, g (N, L*2) output gradient -> (L, T, 2) f32.
    `tile` and `n_chains` shape the reference's TPU kernel and are
    ignored."""
    del tile, n_chains
    return stream_table_grad("tcnn_table_grad", *point_stream(idx, w, g),
                             cfg.table_size)


def hashgrid_encode_fused(table: torch.Tensor, x: torch.Tensor,
                          cfg: HashGridConfig,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """hashgrid_encode with the point-major table-gradient backward (the
    (L, N, 8) corners computed again from x)."""
    return table_grad_encode(
        table, x,
        lambda t, v: hashgrid_encode(t, v, cfg, compute_dtype),
        lambda v, g: hashgrid_table_grad(*hashgrid_indices(v, cfg), g, cfg))
