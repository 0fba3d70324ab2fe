"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips without a CUDA device (decided inside
the fixture, never at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q

(chip_smoke.py runs the same checks at the render's full shapes.)"""

import numpy as np
import pytest
import torch

from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_brick3 as tb3
from radnerf_tpu_torch.ops import marching as tm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_occ_lookup_kernel_equals_plain(dev):
    cfg = tm.MarchConfig(scale=2.0, cascades=3, grid_size=64,
                         exp_step_factor=1 / 256)
    gen = torch.Generator().manual_seed(0)
    occ = (torch.rand((3, 64, 64, 64), generator=gen) < 0.3).to(dev)
    xyz = ((torch.rand((37, 129, 3), generator=gen) - 0.5) * 5).to(dev)
    dt = torch.exp(torch.rand((37, 129), generator=gen) * -8).to(dev)
    before = kernels.launch_counts["occ_lookup"]
    got = tm.occupancy_lookup_bricks(xyz, dt, occ, cfg)
    assert kernels.launch_counts["occ_lookup"] == before + 1
    assert torch.equal(got, tm.occupancy_lookup(xyz, dt, occ, cfg))
    with pytest.raises(ValueError):
        tm.occupancy_lookup_bricks(xyz.double(), dt, occ, cfg)


def test_brick3_kernel_equals_plain(dev):
    cfg = thg.HashGridConfig(n_levels=6, log2_table_size=13,
                             base_resolution=4, per_level_scale=2.0)
    gen = torch.Generator().manual_seed(1)
    table = (torch.rand((6, 1 << 13, 2), generator=gen) * 2 - 1).to(dev)
    x = torch.rand((3001, 3), generator=gen).to(dev)
    packed = tb3.pack_brick3_table(table)
    got = tb3.hashgrid_encode_brick3_fwd_impl(table, x, cfg)
    ref = tb3._encode_plain(packed, x, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (3001, 12)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        tb3.hashgrid_encode_brick3_fwd_impl(table, x[:, :2].contiguous(),
                                            cfg)
    assert np.isfinite(got.float().cpu().numpy()).all()


def test_brick3_table_grad_kernel_equals_plain(dev):
    cfg = thg.HashGridConfig(n_levels=6, log2_table_size=13,
                             base_resolution=4, per_level_scale=2.0)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((3001, 3), generator=gen)
    x[:40] = x[:1]                      # 40 samples on one cell
    g = torch.randn((3001, 12), generator=gen)
    g[100:200] = 0.0                    # masked samples add nothing
    xd, gd = x.to(dev), g.to(dev)
    before = kernels.launch_counts["brick3_table_grad"]
    got = tb3.hashgrid_table_grad_brick3(xd, gd, cfg)
    assert kernels.launch_counts["brick3_table_grad"] == before + 1
    ref = tb3._table_grad_plain(xd, gd, cfg)
    # the same f32 products; atomics add them in another order, which
    # changes from run to run: within 2 (n - 1) u sum|terms| per entry
    idx, w = tb3._corner_terms(xd, cfg)
    gl = gd.reshape(-1, 6, 2).permute(1, 0, 2)
    terms = (w[..., None] * gl[:, None]).abs().reshape(-1, 2)
    abs_sum = torch.zeros((6 * cfg.table_size, 2), device=dev)
    abs_sum.index_add_(0, idx.reshape(-1), terms)
    count = torch.zeros(6 * cfg.table_size, device=dev)
    count.index_add_(0, idx.reshape(-1), torch.ones_like(terms[:, 0]))
    tol = 2 * (count[:, None] - 1).clamp_min(1) * 2.0**-24 * abs_sum
    assert got.shape == (6, cfg.table_size, 2) and got.dtype == torch.float32
    assert ((got - ref).abs().reshape(-1, 2) <= tol).all()
    assert count.max() >= 40
    with pytest.raises(ValueError):
        tb3.hashgrid_table_grad_brick3(xd, gd.half(), cfg)
    with pytest.raises(ValueError):
        tb3.hashgrid_table_grad_brick3(xd, gd[:, :10].contiguous(), cfg)


def test_encode_autograd_launches_both_brick3_kernels(dev):
    cfg = thg.HashGridConfig(n_levels=4, log2_table_size=12,
                             base_resolution=4, per_level_scale=2.0)
    gen = torch.Generator().manual_seed(3)
    table = (torch.rand((4, 1 << 12, 2), generator=gen) - 0.5).to(dev)
    table.requires_grad_(True)
    x = torch.rand((999, 3), generator=gen).to(dev)
    fwd = kernels.launch_counts["brick3_encode_fwd"]
    bwd = kernels.launch_counts["brick3_table_grad"]
    out = tb3.hashgrid_encode_brick3(table, x, cfg)
    out.float().sum().backward()
    assert kernels.launch_counts["brick3_encode_fwd"] == fwd + 1
    assert kernels.launch_counts["brick3_table_grad"] == bwd + 1
    ref = tb3._table_grad_plain(x, torch.ones((999, 8), device=dev), cfg)
    torch.testing.assert_close(table.grad, ref, rtol=1e-5, atol=1e-5)
