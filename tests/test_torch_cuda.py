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
