"""The tcnn-hash table gradient and the slab pair gradient (twin of
radnerf_tpu/ops/hashgrid_window.py).

The reference sorts the (row, w g) update stream and accumulates it with
windowed Pallas kernels, because the TPU has no scatter. The port keeps
the wrappers' contracts and hands the stream, unsorted, to an atomic
scatter kernel (`ops/stream_table_grad.py`): `tcnn_table_grad` for
`sorted_table_grad_window` (one row per entry), `slab_table_grad` for
`sorted_table_grad_window_pair` (rows k and k + 1, the k + 1 == T half
dropped).

The gradient is the exact f32 one: the reference's `pack_f16=False`
path, which it also takes for f32 compute. Its bf16 default rounds each
update to f16 under a per-level power-of-two scale before the sort; the
port does not.
"""

from __future__ import annotations

import torch

from .hashgrid import (
    HashGridConfig, hashgrid_encode, hashgrid_indices_cm, table_grad_encode,
)
from .stream_table_grad import stream_table_grad


def sorted_table_grad_window(sk: torch.Tensor, s0: torch.Tensor,
                             s1: torch.Tensor,
                             table_size: int) -> torch.Tensor:
    """(L, T, 2) f32 gradient of an update stream: entry k of level l adds
    (s0, s1)[l, k] to row sk[l, k]. sk (L, n) int32, s0 and s1 (L, n) f32;
    the stream need not be sorted."""
    return stream_table_grad("tcnn_table_grad", sk.to(torch.int32),
                             torch.stack([s0, s1]).to(torch.float32),
                             table_size)


def tcnn_stream(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The update stream of the tcnn table gradient: (L, 8, N) corner rows
    and weights and the (N, L*2) output gradient -> keys (L, 8N) int32
    and values w * g (2, L, 8N) f32, feature-major."""
    L, _, N = w.shape
    gt = g.T.reshape(L, 2, N).to(torch.float32).transpose(0, 1)  # (2, L, N)
    vals = (w.to(torch.float32)[None] * gt[:, :, None, :]).reshape(
        2, L, 8 * N)
    # (the product's strides follow its inputs', which at N = 1 are not
    # the contiguous ones the kernel takes)
    return (idx.reshape(L, 8 * N).to(torch.int32).contiguous(),
            vals.contiguous())


def hashgrid_table_grad_window(idx: torch.Tensor, w: torch.Tensor,
                               g: torch.Tensor,
                               cfg: HashGridConfig) -> torch.Tensor:
    """dL/dtable of the tcnn encode: idx (L, 8, N) corner rows, w (L, 8, N)
    weights, g (N, L*2) output gradient -> (L, T, 2) f32. The exact
    gradient (the reference's pack_f16=False)."""
    return stream_table_grad("tcnn_table_grad", *tcnn_stream(idx, w, g),
                             cfg.table_size)


def sorted_table_grad_window_pair(
    sk: torch.Tensor, s0e: torch.Tensor, s0o: torch.Tensor,
    s1e: torch.Tensor, s1o: torch.Tensor, table_size: int,
) -> torch.Tensor:
    """(L, T, 2) f32 gradient of a pair stream: entry k of level l adds
    (s0e, s1e) to row sk and (s0o, s1o) to row sk + 1; the row sk + 1 == T
    half is dropped, as the reference's spare slab row drops it."""
    vals = torch.stack([s0e, s1e, s0o, s1o]).to(torch.float32)
    return stream_table_grad("slab_table_grad", sk.to(torch.int32), vals,
                             table_size)


def hashgrid_table_grad_window_pair(
    key: torch.Tensor, v0e: torch.Tensor, v0o: torch.Tensor,
    v1e: torch.Tensor, v1o: torch.Tensor, table_size: int,
) -> torch.Tensor:
    """The reference sorts the pair stream before its kernel; the port's
    kernel takes it in any order, so this is sorted_table_grad_window_pair
    (the exact gradient: the reference's pack_f16=False)."""
    return sorted_table_grad_window_pair(key, v0e, v0o, v1e, v1o,
                                         table_size)


def hashgrid_encode_window(table: torch.Tensor, x: torch.Tensor,
                           cfg: HashGridConfig,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """hashgrid_encode with the scatter-kernel backward, whose (L, 8, N)
    corners are computed again from x (rematerialized, as the
    reference's backward does)."""
    return table_grad_encode(
        table, x,
        lambda t, v: hashgrid_encode(t, v, cfg, compute_dtype),
        lambda v, g: hashgrid_table_grad_window(
            *hashgrid_indices_cm(v, cfg), g, cfg))
