"""The dedup tcnn-hash encode against the windowed one (twin of
examples/bench_dedup.py).

Times the forward and the forward + backward of 'window' and 'dedup' on
ray-ordered samples shaped like the training stream (`ray_stream`), at
T=2^19, L=16, F=2:

  window fw / fwbw   hashgrid_encode_window: gather forward, backward the
                     tcnn_table_grad kernel on the sorted stream
  dedup  fw          hashgrid_encode_dedup's forward
  hybrid fwbw        dedup forward, window backward (grad_impl 'window')
  dgrad  fwbw        grad_impl 'dedup'

The reference also counts each level group's voxel runs against its caps,
the bound of its TPU run merge. The port gathers every corner
(ops/hashgrid_dedup.py) and has no runs or caps, so that report is
printed as not applicable.

    python -m radnerf_tpu_torch.examples.bench_dedup [--n_rays 2048]
        [--per_ray 48] [--mode contiguous|scattered]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.hashgrid import HashGridConfig, init_hashgrid_table
from ..ops.hashgrid_dedup import hashgrid_encode_dedup
from ..ops.hashgrid_window import hashgrid_encode_window
from .common import add_device_arg, device_line, timeit


def ray_stream(n_rays: int, per_ray: int, seed: int = 0,
               mode: str = "contiguous", n_segments: int = 3,
               device="cpu") -> torch.Tensor:
    """(n_rays x per_ray, 3) samples in [0, 1]^3 like the union march's
    output. 'contiguous': each ray's samples form a few runs of
    consecutive lattice points (inside an occupied region every point is
    kept); 'scattered': random lattice points along the whole ray."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = rng.uniform(-0.25, 0.25, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dt = np.sqrt(3.0) / 1024
    span = int(1.0 / dt)
    if mode == "scattered":
        ks = np.sort(rng.choice(span, size=(n_rays, per_ray), replace=True),
                     axis=1)
    else:
        seg_len = per_ray // n_segments
        starts = np.sort(rng.integers(0, span - seg_len,
                                      (n_rays, n_segments)), axis=1)
        ks = (starts[:, :, None] + np.arange(seg_len)[None, None, :]
              ).reshape(n_rays, -1)
        ks = np.pad(ks, ((0, 0), (0, per_ray - ks.shape[1])), mode="edge")
    t = 0.7 + ks * dt
    x = 0.5 + o[:, None, :] + t[..., None] * d[:, None, :]
    return torch.from_numpy(np.clip(x.reshape(-1, 3), 0.0, 1.0).astype(
        np.float32)).to(device)


def run(n_rays: int = 2048, per_ray: int = 48, log2_T: int = 19,
        iters: int = 10, mode: str = "contiguous", device="cuda") -> dict:
    """{label: seconds per call}, each line printed as the reference
    prints it."""
    print(device_line(device), flush=True)
    base = HashGridConfig.for_scene_scale(0.5)
    cfg = HashGridConfig(n_levels=base.n_levels, n_features=2,
                         log2_table_size=log2_T,
                         base_resolution=base.base_resolution,
                         per_level_scale=base.per_level_scale)
    table = init_hashgrid_table(torch.Generator().manual_seed(0), cfg,
                                device=device)
    x = ray_stream(n_rays, per_ray, mode=mode, device=device)
    n = x.shape[0]
    issues = n * cfg.n_levels * 8
    print(f"# stream: {n} samples, {issues / 1e6:.1f}M corner issues "
          f"undeduped", flush=True)
    print("# run counts vs caps: not applicable (the port's dedup encode "
          "gathers every corner: no voxel runs, no caps)", flush=True)

    def fw(encode, **kw):
        def call():
            with torch.no_grad():
                return encode(table, x, cfg, torch.bfloat16, **kw)
        return call

    def fwbw(encode, **kw):
        def call():
            t = table.detach().requires_grad_(True)
            y = encode(t, x, cfg, torch.bfloat16, **kw).float()
            loss = (y ** 2).sum()
            torch.autograd.grad(loss, t)
            return loss.detach()
        return call

    out = {}
    for name, fn in (
            ("window fw  ", fw(hashgrid_encode_window)),
            ("dedup  fw  ", fw(hashgrid_encode_dedup)),
            ("window fwbw", fwbw(hashgrid_encode_window)),
            ("hybrid fwbw", fwbw(hashgrid_encode_dedup)),
            ("dgrad  fwbw", fwbw(hashgrid_encode_dedup, grad_impl="dedup")),
    ):
        dt = timeit(fn, device, warmup=1, iters=iters)
        check = float(fn().float().sum())      # the reference's check=
        out[name.strip()] = dt
        print(f"{name}: {dt * 1e3:8.2f} ms   ({issues / dt / 1e6:7.1f}"
              f" M undeduped-issues/s)  check={check:.4g}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_rays", type=int, default=2048)
    ap.add_argument("--per_ray", type=int, default=48)
    ap.add_argument("--log2_T", type=int, default=19)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", type=str, default="contiguous",
                    choices=["contiguous", "scattered"])
    add_device_arg(ap)
    a = ap.parse_args(argv)
    return run(a.n_rays, a.per_ray, a.log2_T, a.iters, a.mode, a.device)


if __name__ == "__main__":
    main()
