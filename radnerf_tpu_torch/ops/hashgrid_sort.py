"""The sort-based tcnn-hash table gradient (twin of
radnerf_tpu/ops/hashgrid_sort.py).

The reference sorts the update stream and scatter-adds it with XLA's
sorted-index hint, because an unsorted scatter serializes on the TPU. It
has no Pallas kernel. On Hopper the sort buys nothing: the port adds the
unsorted stream with the tcnn scatter kernel, the same f32 sums in
another order.
"""

from __future__ import annotations

import torch

from .hashgrid import HashGridConfig
from .hashgrid_window import hashgrid_encode_window, hashgrid_table_grad_window


def hashgrid_table_grad_sort(idx: torch.Tensor, w: torch.Tensor,
                             g: torch.Tensor,
                             cfg: HashGridConfig) -> torch.Tensor:
    """dL/dtable from (L, 8, N) corner rows and weights and the (N, L*2)
    output gradient: (L, T, 2) f32, through the tcnn scatter kernel."""
    return hashgrid_table_grad_window(idx, w, g, cfg)


def hashgrid_encode_sort(table: torch.Tensor, x: torch.Tensor,
                         cfg: HashGridConfig,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """hashgrid_encode with the sort family's backward, which on the card
    is the window family's."""
    return hashgrid_encode_window(table, x, cfg, compute_dtype)
