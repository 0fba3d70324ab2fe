"""Hash-grid table gradients from an update stream: the wrappers of the
three entry points of `csrc/stream_table_grad.cu` and their plain twin.

A stream is (L, n) int32 keys and (2 * P, L, n) f32 value planes: entry k
of level l adds (vals[2c, l, k], vals[2c + 1, l, k]) to table entry
keys[l, k] + OFFSETS[name][c] of level l, for each of the kernel's P
offsets, and an entry that lands on T or beyond is dropped (the slab
family's k + 1 == T half). The result is the (L, T, 2) f32 gradient.

  tcnn_table_grad   offsets (0,)            the tcnn-hash families
  slab_table_grad   offsets (0, 1)          the slab x-pair stream
  brick_table_grad  offsets (0, 1, 11, 12)  the brick xy-corner stream

`stream_table_grad` launches the named CUDA kernel on CUDA tensors and
runs `stream_table_grad_plain` (one `index_add_`) on CPU tensors. The
stream need not be sorted.
"""

from __future__ import annotations

import torch

from .. import kernels

OFFSETS = {
    "tcnn_table_grad": (0,),
    "slab_table_grad": (0, 1),
    "brick_table_grad": (0, 1, 11, 12),
}


def stream_terms(name: str, keys: torch.Tensor, vals: torch.Tensor,
                 table_size: int):
    """Flat (L * T) entry and (feature 0, feature 1) value of every term of
    the stream: (m,) int64 and (m, 2) f32. A term that lands on T or
    beyond is aimed at its level's entry T - 1 with a zero value (it adds
    nothing)."""
    L, n = keys.shape
    T = table_size
    base = torch.arange(L, device=keys.device)[:, None] * T
    flat, terms = [], []
    for c, off in enumerate(OFFSETS[name]):
        e = keys.long() + off
        keep = e < T
        v = torch.stack([vals[2 * c], vals[2 * c + 1]], dim=-1)
        flat.append((base + torch.where(keep, e, T - 1)).reshape(-1))
        terms.append(torch.where(keep[..., None], v, 0.0).reshape(-1, 2))
    return torch.cat(flat), torch.cat(terms)


def stream_table_grad_plain(name: str, keys: torch.Tensor,
                            vals: torch.Tensor,
                            table_size: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernels: `index_add_` of every term into
    the flat (L * T, 2) table."""
    L = keys.shape[0]
    flat, terms = stream_terms(name, keys, vals, table_size)
    out = torch.zeros((L * table_size, 2), dtype=torch.float32,
                      device=keys.device)
    out.index_add_(0, flat, terms)
    return out.reshape(L, table_size, 2)


def _stream_table_grad_cuda(name: str, keys: torch.Tensor,
                            vals: torch.Tensor,
                            table_size: int) -> torch.Tensor:
    L, n = keys.shape
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32, got {keys.dtype}")
    if vals.shape != (2 * len(OFFSETS[name]), L, n):
        raise ValueError(f"{name} takes values of shape "
                         f"{(2 * len(OFFSETS[name]), L, n)}, got "
                         f"{tuple(vals.shape)}")
    if not (keys.is_cuda and vals.device == keys.device):
        raise ValueError("keys and values must be on the same CUDA device")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    out = torch.zeros((L, table_size, 2), dtype=torch.float32,
                      device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch(name, keys.data_ptr(), vals.data_ptr(),
                       out.data_ptr(), n, L, table_size, stream)
    return out


def stream_table_grad(name: str, keys: torch.Tensor, vals: torch.Tensor,
                      table_size: int) -> torch.Tensor:
    """(L, T, 2) f32 gradient of the stream (keys (L, n) int32, vals
    (2 * P, L, n) f32) through kernel `name`."""
    if name not in OFFSETS:
        raise ValueError(f"unknown stream kernel {name!r}")
    if vals.dtype != torch.float32:
        raise ValueError(f"values must be float32, got {vals.dtype}")
    if keys.is_cuda:
        return _stream_table_grad_cuda(name, keys, vals, table_size)
    if keys.device.type != "cpu":
        raise ValueError(f"no {name} for device {keys.device}")
    return stream_table_grad_plain(name, keys, vals, table_size)
