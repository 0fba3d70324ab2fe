"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips without a CUDA device (decided inside
the fixture, never at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q

(chip_smoke.py runs the same checks at the render's full shapes.)"""

import numpy as np
import pytest
import torch

from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.examples import bench_vmem_gather as tvg
from radnerf_tpu_torch.examples import proto_pallas_gather as tpg
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_brick as tbr
from radnerf_tpu_torch.ops import hashgrid_brick3 as tb3
from radnerf_tpu_torch.ops import hashgrid_slab as tsl
from radnerf_tpu_torch.ops import hashgrid_window as thw
from radnerf_tpu_torch.ops import marching as tm
from radnerf_tpu_torch.ops import stream_table_grad as tsg

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
    before = kernels.launches()["occ_lookup"]
    got = tm.occupancy_lookup_bricks(xyz, dt, occ, cfg)
    assert kernels.launches()["occ_lookup"] == before + 1
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
    assert torch.equal(
        tb3.hashgrid_encode_brick3_fwd_impl(table, x, cfg, packed=packed),
        ref)
    with pytest.raises(ValueError):
        tb3.hashgrid_encode_brick3_fwd_impl(table, x[:, :2].contiguous(),
                                            cfg)
    with pytest.raises(ValueError):
        tb3.hashgrid_encode_brick3_fwd_impl(table.half(), x, cfg)
    assert np.isfinite(got.float().cpu().numpy()).all()


# (levels, config): one hashed level; 16 dense and hashed; 32, the
# kernel's most (its shared-memory tile and level parameters)
ENCODE_LEVELS = {
    1: dict(n_levels=1, log2_table_size=12, base_resolution=16,
            per_level_scale=2.0),
    16: dict(n_levels=16, log2_table_size=13, base_resolution=4,
             per_level_scale=1.3),
    32: dict(n_levels=32, log2_table_size=12, base_resolution=4,
             per_level_scale=1.15),
}


def _ray_samples(n: int, gen) -> torch.Tensor:
    """n samples in ray order: rays of 96 samples at a 1/512 step."""
    n_rays = -(-n // 96)
    o = torch.rand((n_rays, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3),
                                                  generator=gen), dim=1)
    t = torch.arange(96) / 512.0
    x = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)[:n]
    return x.clamp(0.0, 1.0).contiguous()


@pytest.mark.parametrize("order", ["rays", "shuffled"])
@pytest.mark.parametrize("n", [0, 1, 64 * 40 + 37])
@pytest.mark.parametrize("levels", [1, 16, 32])
def test_brick3_encode_tiles_equal_plain(dev, levels, n, order):
    """Both table forms, bit-equal to the plain twin: an empty and a
    one-sample call, a ragged last tile, 1 to 32 levels, a ray-ordered
    stream (a warp's samples share cells) and the same samples
    shuffled."""
    cfg = thg.HashGridConfig(**ENCODE_LEVELS[levels])
    assert {a.dense for a in tb3.brick3_addrs(cfg)} == (
        {False} if levels == 1 else {True, False})
    gen = torch.Generator().manual_seed(levels * 7 + n)
    table = (torch.rand((levels, cfg.table_size, 2), generator=gen) * 2
             - 1).to(dev)
    x = _ray_samples(n, gen)
    if order == "shuffled":
        x = x[torch.randperm(n, generator=gen)]
    x = x.to(dev)
    packed = tb3.pack_brick3_table(table)
    ref = tb3._encode_plain(packed, x, cfg)
    before = kernels.launches()["brick3_encode_fwd"]
    for got in (tb3.hashgrid_encode_brick3_fwd_impl(table, x, cfg),
                tb3.hashgrid_encode_brick3_fwd_impl(table, x, cfg,
                                                    packed=packed)):
        assert got.shape == (n, 2 * levels) and torch.equal(got, ref)
    assert kernels.launches()["brick3_encode_fwd"] == before + 2


def test_brick3_encode_f32_table_rounds_ties_to_even(dev):
    """Every table value halfway between two bf16 values: the kernel's
    read of the f32 table rounds each to even, as the pack does."""
    cfg = thg.HashGridConfig(**ENCODE_LEVELS[16])
    gen = torch.Generator().manual_seed(11)
    bf = (torch.rand((16, cfg.table_size, 2), generator=gen) * 2 - 1).to(
        torch.bfloat16)
    bits = (bf.view(torch.int16).to(torch.int32) << 16) | 0x8000
    table = bits.view(torch.float32)
    packed = tb3.pack_brick3_table(table)
    lo, hi = tb3._unpack_bf16(packed.reshape(-1))
    rounded = torch.stack([lo, hi], -1).reshape(table.shape)
    up = rounded.float().abs() > table.abs()
    assert up.any() and (~up).any()      # ties went both ways (to even)
    x = _ray_samples(5000, gen)
    ref = tb3._encode_plain(packed, x, cfg)
    table, x = table.to(dev), x.to(dev)
    assert torch.equal(tb3.hashgrid_encode_brick3_fwd_impl(table, x, cfg),
                       ref.to(dev))
    assert torch.equal(tb3._encode_plain(table, x, cfg), ref.to(dev))


def test_brick3_table_grad_kernel_equals_plain(dev):
    cfg = thg.HashGridConfig(n_levels=6, log2_table_size=13,
                             base_resolution=4, per_level_scale=2.0)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((3001, 3), generator=gen)
    x[:40] = x[:1]                      # 40 samples on one cell
    g = torch.randn((3001, 12), generator=gen)
    g[100:200] = 0.0                    # masked samples add nothing
    xd, gd = x.to(dev), g.to(dev)
    before = kernels.launches()["brick3_table_grad"]
    got = tb3.hashgrid_table_grad_brick3(xd, gd, cfg)
    assert kernels.launches()["brick3_table_grad"] == before + 1
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
    fwd = kernels.launches()["brick3_encode_fwd"]
    bwd = kernels.launches()["brick3_table_grad"]
    out = tb3.hashgrid_encode_brick3(table, x, cfg)
    out.float().sum().backward()
    assert kernels.launches()["brick3_encode_fwd"] == fwd + 1
    assert kernels.launches()["brick3_table_grad"] == bwd + 1
    ref = tb3._table_grad_plain(x, torch.ones((999, 8), device=dev), cfg)
    torch.testing.assert_close(table.grad, ref, rtol=1e-5, atol=1e-5)


def _order_tol(name, keys, vals, T):
    """2 (n - 1) u sum|terms| per entry: atomics add the same f32 terms
    in an order that changes from run to run."""
    L = keys.shape[0]
    flat, terms = tsg.stream_terms(name, keys, vals, T)
    abs_sum = torch.zeros((L * T, 2), device=keys.device).index_add_(
        0, flat, terms.abs())
    count = torch.zeros((L * T, 2), device=keys.device).index_add_(
        0, flat, (terms != 0).float())
    return (2 * (count - 1).clamp_min(1) * 2.0**-24 * abs_sum).reshape(
        L, T, 2), count


@pytest.mark.parametrize("name", list(tsg.OFFSETS))
def test_stream_table_grad_kernel_equals_plain(dev, name):
    L, n, T = 5, 40000, 1 << 12
    gen = torch.Generator().manual_seed(4)
    keys = torch.randint(0, 64, (L, n), generator=gen, dtype=torch.int32)
    if name == "brick_table_grad":          # row * 128 + lane0
        lane0 = (torch.randint(0, 10, (L, n), generator=gen)
                 + 11 * torch.randint(0, 10, (L, n), generator=gen))
        keys = (torch.randint(0, 2, (L, n), generator=gen) * 128
                + lane0).int()
    else:                                   # slab drops the k + 1 == T half
        keys[:, :50] = T - 1
    vals = torch.randn((2 * len(tsg.OFFSETS[name]), L, n), generator=gen)
    vals[:, :, 100:300] = 0.0               # masked entries add nothing
    # even and odd keys among the entries that add: slab's 16-byte (k
    # even) and two 8-byte (k odd) paths, brick's two pair alignments
    # ((k, k + 1) or (k + 11, k + 12) aligned); slab's T - 1 too
    live = keys[vals.ne(0).any(0)]
    assert (live % 2 == 0).any() and (live % 2 == 1).any()
    if name == "slab_table_grad":
        assert (live == T - 1).any()
    kd, vd = keys.to(dev), vals.to(dev)
    before = kernels.launches()[name]
    got = tsg.stream_table_grad(name, kd, vd, T)
    assert kernels.launches()[name] == before + 1
    ref = tsg.stream_table_grad_plain(name, kd, vd, T)
    tol, count = _order_tol(name, kd, vd, T)
    assert got.shape == (L, T, 2) and got.dtype == torch.float32
    assert ((got - ref).abs() <= tol).all()
    assert count.max() >= 100
    # the same stream on the CPU twin: the card adds what the CPU adds
    cpu = tsg.stream_table_grad_plain(name, keys, vals, T)
    assert ((got.cpu() - cpu).abs() <= tol.cpu()).all()
    with pytest.raises(ValueError):
        tsg.stream_table_grad(name, kd.long(), vd, T)
    with pytest.raises(ValueError):
        tsg.stream_table_grad(name, kd, vd[:1].contiguous(), T)


# streams made for the warp aggregation of brick3_table_grad and the
# stream kernels: every sample in one cell with positive gradients (the
# order bound then lies below the entry itself), samples spread uniformly,
# runs of 8 on one point with every third gradient zero, rays of 64
# samples 2^-10 apart at a ragged length; and single samples
AGG_CASES = [("one cell", 3001), ("uniform", 3001),
             ("runs of 8, zero-gradient members", 3001),
             ("rays, ragged length", 2988), ("uniform", 1), ("uniform", 33)]


def _agg_inputs(case, n, L, dev):
    gen = torch.Generator().manual_seed(6)
    g = torch.randn((n, 2 * L), generator=gen)
    k = torch.arange(n)
    if case == "one cell":
        x = torch.rand((1, 3), generator=gen).expand(n, 3)
        g = g.abs()
    elif case == "uniform":
        x = torch.rand((n, 3), generator=gen)
    elif case.startswith("runs of 8"):
        x = torch.rand((-(-n // 8), 3), generator=gen)[k // 8]
        g = torch.where((k % 3 == 0)[:, None], 0.0, g)
    else:
        d = torch.randn((-(-n // 64), 3), generator=gen)
        d = d / d.norm(dim=1, keepdim=True)
        o = 0.25 + 0.5 * torch.rand((-(-n // 64), 3), generator=gen)
        x = (o[k // 64] + d[k // 64] * ((k % 64)[:, None] * 2.0**-10)
             ).clamp(0.0, 1.0)
    return x.contiguous().to(dev), g.contiguous().to(dev)


@pytest.mark.parametrize("case,n", AGG_CASES)
def test_table_grad_kernels_on_aggregation_streams(dev, case, n):
    cfg = thg.HashGridConfig(n_levels=6, log2_table_size=13,
                             base_resolution=4, per_level_scale=2.0)
    L, T = cfg.n_levels, cfg.table_size
    x, g = _agg_inputs(case, n, L, dev)
    # brick3: within 2 (n - 1) u sum|terms| of the twin per entry
    got = tb3.hashgrid_table_grad_brick3(x, g, cfg)
    ref = tb3._table_grad_plain(x, g, cfg)
    idx, w = tb3._corner_terms(x, cfg)
    terms = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None]
             ).abs().reshape(-1, 2)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, idx.reshape(-1), terms)
    count = torch.zeros(L * T, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones_like(terms[:, 0]))
    tol = 2 * (count[:, None] - 1).clamp_min(1) * 2.0**-24 * abs_sum
    assert ((got - ref).abs().reshape(-1, 2) <= tol).all()
    if case == "one cell":
        assert count.max() == n
    # the stream kernels on the streams their backwards build from the
    # same samples: tcnn on the dedup path's corner-major stream, slab on
    # its pair stream (padded to 128 samples), brick on its xy-corner one
    key, (v0e, v0o, v1e, v1o) = tsl._bwd_streams(x, g, cfg)
    bkey, bvals = tbr._bwd_streams(x, g, cfg)
    for name, (keys, vals) in (
            ("tcnn_table_grad",
             thw.tcnn_stream(*thg.hashgrid_indices_cm(x, cfg), g)),
            ("slab_table_grad", (key, torch.stack([v0e, v1e, v0o, v1o]))),
            ("brick_table_grad", (bkey, torch.stack(bvals)))):
        before = kernels.launches()[name]
        got = tsg.stream_table_grad(name, keys, vals, T)
        assert kernels.launches()[name] == before + 1
        ref = tsg.stream_table_grad_plain(name, keys, vals, T)
        tol, _ = _order_tol(name, keys, vals, T)
        assert ((got - ref).abs() <= tol).all(), name


@pytest.mark.parametrize("impl,kernel", [
    ("dedup", "tcnn_table_grad"), ("window", "tcnn_table_grad"),
    ("pallas", "tcnn_table_grad"), ("slab", "slab_table_grad"),
    ("brick", "brick_table_grad")])
def test_family_backward_launches_its_kernel(dev, impl, kernel):
    cfg = thg.HashGridConfig(n_levels=6, log2_table_size=13,
                             base_resolution=4, per_level_scale=2.0)
    gen = torch.Generator().manual_seed(5)
    table = (torch.rand((6, 1 << 13, 2), generator=gen) - 0.5)
    x = torch.rand((3000, 3), generator=gen)
    g = torch.randn((3000, 12), generator=gen)
    grads = []
    for where in (dev, torch.device("cpu")):
        t = table.to(where).requires_grad_(True)
        before = kernels.launches()
        out = thg.encode_dispatch(t, x.to(where), cfg, torch.bfloat16, impl)
        (out.float() * g.to(where)).sum().backward()
        if where == dev:
            assert kernels.launches()[kernel] == before[kernel] + 1
            assert all(kernels.launches()[k] == before[k]
                       for k in before if k != kernel)
            fwd = out.cpu()
        else:
            assert torch.equal(fwd, out)      # the forward is plain PyTorch
        grads.append(t.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


def test_vmem_gather_kernels_equal_plain(dev):
    x = tvg.make_inputs(128 * 517, 300, dev, seed=6)
    x["rows2d"][0, :5] = torch.tensor([0, 299, 150, 299, 0])
    for name, fn, plain, args in (
            ("tal_sublane", tvg.tal_sublane, tvg.tal_sublane_plain,
             (x["tbl"], x["rows2d"])),
            ("rowgather_onehot", tvg.rowgather_onehot,
             tvg.rowgather_onehot_plain, (x["tbl"], x["row"], x["lane"]))):
        before = kernels.launches()[name]
        got = fn(*args)
        assert kernels.launches()[name] == before + 1
        assert got.dtype == torch.int32 and got.shape == args[1].shape
        assert torch.equal(got, plain(*args))
        assert torch.equal(got.cpu(), fn(*(a.cpu() for a in args)))
    with pytest.raises(ValueError):
        tvg.tal_sublane(x["tbl"], x["rows2d"].long())


GATHER_ENTRY_POINTS = ("tal_sublane", "tal_sublane_l2", "rowgather_onehot")


def _gather_launch(name, tbl, *idx):
    """One launch of a kernel-8 entry point, whatever R, bypassing
    tal_sublane's pick."""
    out = torch.empty_like(idx[0])
    kernels.launch(name, tbl.data_ptr(), *(t.data_ptr() for t in idx),
                   out.data_ptr(), out.numel(), tbl.shape[0],
                   torch.cuda.current_stream().cuda_stream)
    return out


def _gather_args(name, x):
    if name.startswith("tal_sublane"):
        return tvg.tal_sublane_plain, (x["tbl"], x["rows2d"])
    return tvg.rowgather_onehot_plain, (x["tbl"], x["row"], x["lane"])


# (entry point, R, E): R = 300 (no power of two), 4096 (the script's),
# tal_sublane's staged limit, and one row above it (where the staged
# kernel refuses); E = 128 words (one tile) or 517 tiles (the last block
# not filled)
GATHER_CASES = [
    (name, n_rows, elems)
    for name in GATHER_ENTRY_POINTS
    for n_rows, elems in ((300, 128), (300, 128 * 517), (4096, 128 * 517),
                          (tvg.STAGED_MAX_ROWS, 128 * 517),
                          (tvg.STAGED_MAX_ROWS + 1, 128 * 517))
    if name != "tal_sublane" or n_rows <= tvg.STAGED_MAX_ROWS]


@pytest.mark.parametrize("name,n_rows,elems", GATHER_CASES)
def test_vmem_gather_entry_points_equal_plain_with_edges(dev, name, n_rows,
                                                         elems):
    """Each kernel-8 entry point bit-equal to its twin on the default
    draw and on the edge draw (rows from the end and outside the table,
    lanes outside [0, 128), mixed into the random indices)."""
    x = tvg.make_inputs(elems, n_rows, dev, seed=n_rows)
    for draw in (x, tvg.with_edges(x, n_rows)):
        plain, args = _gather_args(name, draw)
        before = kernels.launches()[name]
        got = _gather_launch(name, *args)
        assert kernels.launches()[name] == before + 1
        assert torch.equal(got, plain(*args))
    assert (got == -1).any()
    if name == "rowgather_onehot":
        assert (got[(args[2] < 0) | (args[2] >= 128)] == 0).all()


@pytest.mark.parametrize("n_rows", [tvg.STAGED_MAX_ROWS,
                                    tvg.STAGED_MAX_ROWS + 1])
def test_vmem_gather_wrappers_pick_the_kernel_by_rows(dev, n_rows):
    """At the staged limit tal_sublane launches its staged kernel; one row
    above it, tal_sublane_l2; rowgather_onehot has one kernel for any R;
    each bit-equal to its twin."""
    x = tvg.with_edges(tvg.make_inputs(128 * 300, n_rows, dev, seed=2),
                       n_rows)
    staged = n_rows <= tvg.STAGED_MAX_ROWS
    for fn, name, launched in (
            (tvg.tal_sublane, "tal_sublane",
             {"tal_sublane": int(staged), "tal_sublane_l2": int(not staged),
              "rowgather_onehot": 0}),
            (tvg.rowgather_onehot, "rowgather_onehot",
             {"tal_sublane": 0, "tal_sublane_l2": 0,
              "rowgather_onehot": 1})):
        plain, args = _gather_args(name, x)
        before = kernels.launches()
        got = fn(*args)
        assert {k: kernels.launches()[k] - before[k]
                for k in launched} == launched
        assert torch.equal(got, plain(*args))


def test_tal_sublane_staged_launch_refused_raises(dev):
    """The staged kernel asked for more shared memory than a block has (a
    table one row above the limit: a 232,480-byte slice) refuses the
    launch: the call raises and counts nothing, and the next launch runs
    and is right."""
    n_rows = tvg.STAGED_MAX_ROWS + 1
    x = tvg.make_inputs(128 * 64, n_rows, dev, seed=3)
    plain, args = _gather_args("tal_sublane", x)
    before = kernels.launches()["tal_sublane"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        _gather_launch("tal_sublane", *args)
    assert kernels.launches()["tal_sublane"] == before
    y = tvg.make_inputs(128 * 64, 4096, dev, seed=3)
    plain, args = _gather_args("tal_sublane", y)
    got = _gather_launch("tal_sublane", *args)
    assert kernels.launches()["tal_sublane"] == before + 1
    assert torch.equal(got, plain(*args))


def test_tal_sublane_rejects_a_misaligned_table(dev):
    """The staged kernel copies the table in 16-byte chunks: a table at a
    4-byte offset is refused by the wrapper (ValueError), and the same
    words through rowgather_onehot are gathered right."""
    x = tvg.make_inputs(128 * 8, 64, dev, seed=5)
    words = torch.empty(64 * 128 + 1, dtype=torch.int32, device=dev)
    tbl = words[1:].view(64, 128)
    tbl.copy_(x["tbl"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tvg.tal_sublane(tbl, x["rows2d"])
    assert torch.equal(tvg.rowgather_onehot(tbl, x["row"], x["lane"]),
                       tvg.rowgather_onehot_plain(x["tbl"], x["row"],
                                                  x["lane"]))


def test_proto_gather_kernels_equal_plain(dev):
    n_rows, m = 5000, 200_003
    x = tpg.make_inputs(n_rows, m, dev)
    x["idx"][:1000] = 17                          # one row hit 1000+ times
    before = kernels.launches()["pallas_gather"]
    got = tpg.pallas_gather(x["table"], x["idx"])
    assert kernels.launches()["pallas_gather"] == before + 1
    assert torch.equal(got, tpg.pallas_gather_plain(x["table"], x["idx"]))
    before = kernels.launches()["pallas_scatter"]
    got = tpg.pallas_scatter(x["idx"], x["vals"], n_rows)
    assert kernels.launches()["pallas_scatter"] == before + 1
    # atomics add the same f32 terms in an order that changes from run to
    # run: within 2 (n - 1) u sum|terms| per entry, of the card's twin and
    # of the CPU's
    bound = tpg.scatter_order_bound(x["idx"], x["vals"], n_rows)
    ref = tpg.pallas_scatter_plain(x["idx"], x["vals"], n_rows)
    assert ((got - ref).abs() <= bound).all()
    cpu = tpg.pallas_scatter(x["idx"].cpu(), x["vals"].cpu(), n_rows)
    assert ((got.cpu() - cpu).abs() <= bound.cpu()).all()
    with pytest.raises(ValueError):
        tpg.pallas_scatter(x["idx"], x["vals"].double(), n_rows)


def _scatter_inputs(case: str, m: int, n_rows: int, dev):
    """idx (m,) int32 and vals (m, 2) f32 of one case; views at an offset
    for "offset rows" (vals 8- but not 16-byte aligned) and "odd floats"
    (idx and vals at an odd element offset: 4-byte aligned only)."""
    gen = torch.Generator().manual_seed(len(case))
    idx = torch.randint(0, n_rows, (m + 1,), generator=gen,
                        dtype=torch.int32)
    vals = torch.randn((m + 1, 2), generator=gen)
    if case == "outside":
        idx[::7] = torch.tensor([-1, n_rows, n_rows + 5, -(1 << 30),
                                 -n_rows, -n_rows - 1],
                                dtype=torch.int32).repeat(m // 7 + 1)[
                                    :idx[::7].shape[0]]
    if case == "one row":
        idx[:] = 5
    idx, vals = idx.to(dev), vals.to(dev)
    if case == "offset rows":
        return idx[1:], vals[1:]
    if case == "odd floats":
        return idx[1:], vals.reshape(-1)[1:2 * m + 1].view(m, 2)
    return idx[:m], vals[:m]


def test_examples_kernels_count_negative_indices_from_the_end(dev):
    """pallas_gather and pallas_scatter take an index in [-T, 0) as row
    T + i, as jnp.take and .at[].add do, and an index outside [-T, T) as
    outside the table (NaN gathered, update dropped)."""
    n_rows, m = 5000, 70_001
    x = tpg.make_inputs(n_rows, m, dev)
    edges = torch.tensor([-1, -n_rows, -n_rows - 1, n_rows, -2, 0],
                         dtype=torch.int32, device=dev)
    idx = x["idx"].clone()
    idx[::3] = edges.repeat(m // 18 + 1)[:idx[::3].shape[0]]
    got = tpg.pallas_gather(x["table"], idx)
    assert torch.equal(got.view(torch.int32), tpg.pallas_gather_plain(
        x["table"], idx).view(torch.int32))          # NaN bits included
    assert torch.equal(got[idx == -1],
                       x["table"][-1].expand((idx == -1).sum(), 2))
    assert got[(idx < -n_rows) | (idx >= n_rows)].isnan().all()
    assert not got[(idx >= -n_rows) & (idx < n_rows)].isnan().any()
    got = tpg.pallas_scatter(idx, x["vals"], n_rows)
    ref = tpg.pallas_scatter_plain(idx, x["vals"], n_rows)
    bound = tpg.scatter_order_bound(idx, x["vals"], n_rows)
    assert ((got - ref).abs() <= bound).all()
    last = x["vals"][(idx == -1) | (idx == n_rows - 1)].sum(0)
    assert ((got[-1] - last).abs() <= bound[-1]).all()


@pytest.mark.parametrize("case", ["tail", "offset rows", "odd floats",
                                  "outside", "one row"])
def test_pallas_scatter_views_tails_outside_and_one_row(dev, case):
    """M = 2^20 + 3 (a vector tail of 3), idx and vals at offsets that
    misalign their 16-byte loads, indices outside the table (dropped) and
    in [-n_rows, 0) (counted from the end), and every update to one row
    (n = M): within the order bound of the plain twin, which adds in
    index order."""
    n_rows, m = 1 << 19, (1 << 20) + 3
    idx, vals = _scatter_inputs(case, m, n_rows, dev)
    assert idx.shape == (m,) and vals.shape == (m, 2)
    assert idx.is_contiguous() and vals.is_contiguous()
    before = kernels.launches()["pallas_scatter"]
    got = tpg.pallas_scatter(idx, vals, n_rows)
    assert kernels.launches()["pallas_scatter"] == before + 1
    ref = tpg.pallas_scatter_plain(idx, vals, n_rows)
    bound = tpg.scatter_order_bound(idx, vals, n_rows)
    assert ((got - ref).abs() <= bound).all()
    if case == "outside":
        assert not ((idx >= 0) & (idx < n_rows)).all()
    if case == "one row":
        assert bound[5].min() > 0 and (got[:5] == 0).all()


GATHER_9A_CASES = ["tail", "M = 0", "M = 1", "M = 2", "M = 3", "M = 5",
                   "idx at offset 1", "idx at offset 2", "idx at offset 3",
                   "table at an odd offset", "one row", "edges"]


def _gather_inputs(case: str, dev):
    """table (2^19, 2) f32 and idx (m,) int32 of one case: m = 2^20 + 3
    (the last block not filled) unless the case names m; idx views at element
    offsets 1-3 (4-, 8- and 4-byte aligned); a table view at an odd
    element offset (4-byte aligned only); every index on one row;
    with_edges' draw."""
    n_rows, m = 1 << 19, (1 << 20) + 3
    if case.startswith("M = "):
        m = int(case[4:])
    x = tpg.make_inputs(n_rows, m + 3, dev)
    table, idx = x["table"], x["idx"]
    if case == "edges":
        idx = tpg.with_edges(x, n_rows)["idx"]
    if case == "one row":
        idx = torch.full_like(idx, 5)
    if case.startswith("idx at offset"):
        k = int(case[-1])
        return table, idx[k:k + m]
    if case == "table at an odd offset":
        words = torch.empty(2 * n_rows + 1, device=dev)
        table = words[1:].view(n_rows, 2)
        table.copy_(x["table"])
        assert table.data_ptr() % 8 == 4
    return table, idx[:m]


@pytest.mark.parametrize("case", GATHER_9A_CASES)
def test_pallas_gather_views_tails_edges_and_one_row(dev, case):
    """pallas_gather bit-equal to its twin (int32 words, NaN bits
    included) on M = 2^20 + 3 and on a few rows, idx views at element
    offsets 1-3, a table that is 4- but not 8-byte aligned (its rows then
    read with two 4-byte loads), every index on one row and the edge
    draw (rows from the end and outside the table); one launch counted a
    call."""
    table, idx = _gather_inputs(case, dev)
    assert idx.is_contiguous() and table.is_contiguous()
    before = kernels.launches()["pallas_gather"]
    got = tpg.pallas_gather(table, idx)
    assert kernels.launches()["pallas_gather"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (idx.shape[0], 2)
    assert torch.equal(got.view(torch.int32), tpg.pallas_gather_plain(
        table, idx).view(torch.int32))
    if case == "edges":
        assert got.isnan().any() and not got.isnan().all()


def test_get_rays_on_the_card_equals_the_cpu(dev):
    """The ray directions are written-out dot products, so the card
    computes the CPU's bits (a batched matmul would round them
    otherwise, and move the samples' encode)."""
    from radnerf_tpu_torch.render.ml_render import get_rays

    gen = torch.Generator().manual_seed(7)
    d = torch.randn((4099, 3), generator=gen)
    c2w = torch.randn((4099, 3, 4), generator=gen)
    for pose in (c2w, c2w[0]):
        o_cpu, d_cpu = get_rays(d, pose)
        o_dev, d_dev = get_rays(d.to(dev), pose.to(dev))
        assert torch.equal(d_dev.cpu(), d_cpu)
        assert torch.equal(o_dev.cpu(), o_cpu)
