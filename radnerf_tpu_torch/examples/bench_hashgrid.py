"""Microbenchmark: the tcnn-hash encode forward + backward, the point-major
table-gradient kernel against autograd's scatter-add, at training sizes
(T=2^19, L=16, F=2; N = rays x budget x experts samples per step) (twin
of examples/bench_hashgrid.py).

  fw only (xla gather)   hashgrid_encode, a PyTorch gather
  fw+bw (xla scatter)    its autograd backward (index_put_ accumulate)
  fw+bw (pallas)         hashgrid_encode_fused: the backward is the
                         tcnn_table_grad kernel on the point-major stream

    python -m radnerf_tpu_torch.examples.bench_hashgrid [N]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.hashgrid import HashGridConfig, hashgrid_encode, init_hashgrid_table
from ..ops.hashgrid_pallas import hashgrid_encode_fused
from .common import add_device_arg, device_line, timeit


def table_and_samples(n: int, log2_T: int, device):
    """The field's config at scene scale 0.5, a table from seed 0 and n
    uniform samples from seed 1."""
    cfg = HashGridConfig.for_scene_scale(0.5, log2_table_size=log2_T)
    table = init_hashgrid_table(torch.Generator().manual_seed(0), cfg,
                                device=device)
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(1)).to(
        device)
    return cfg, table, x


def fwbw(f, table: torch.Tensor, x: torch.Tensor):
    """Sum of the table gradient of sum(f(table, x)**2), f's output in
    f32."""
    t = table.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((f(t, x).float() ** 2).sum(), t)
    return g.sum()


def run(n: int = 196_608, log2_T: int = 19, device="cuda") -> dict:
    print(device_line(device), flush=True)
    cfg, table, x = table_and_samples(n, log2_T, device)
    print(f"# N={n} T=2^{log2_T} L={cfg.n_levels}")
    out = {}

    def fw_xla(t, xx):
        return hashgrid_encode(t, xx, cfg, torch.bfloat16)

    def fw_pl(t, xx):
        return hashgrid_encode_fused(t, xx, cfg, torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return fw_xla(table, x).float().sum()

    t = out["fw only (xla gather)"] = timeit(fwd, device)
    print(f"fw only (xla gather):      {t * 1e3:8.2f} ms")
    for name, f in (("xla scatter", fw_xla), ("pallas", fw_pl)):
        dt = out[f"fw+bw ({name})"] = timeit(lambda f=f: fwbw(f, table, x),
                                             device)
        print(f"fw+bw ({name:12s}): {dt * 1e3:8.2f} ms "
              f"({n / dt / 1e6:.1f} Mpts/s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=196_608)
    args = add_device_arg(ap).parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
