"""PyTorch port vs the JAX package, brick3 hash-grid forward: level
configuration, row addressing (dense and hashed levels), geometry, table
packing, the f32 golden path, and the forward (the CUDA kernel's plain
twin on the CPU) against the reference's 'plain' and 'runs' modes.

The JAX side is jitted, as the render runs it: XLA then contracts
x * scale + 0.5 into a fused multiply-add, which the port mirrors; its
'runs' mode reaches the Pallas extract kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import hashgrid as jhg
from radnerf_tpu.ops import hashgrid_brick as jhb
from radnerf_tpu.ops import hashgrid_brick3 as jb3
from radnerf_tpu_torch.models.mngp import MNGPConfig, _encode
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_brick3 as tb3

torch.set_num_threads(1)

# res 4..128 over 6 levels: dense AND hashed classes (the JAX suite's CFG)
J_CFG = jhg.HashGridConfig(n_levels=6, n_features=2, log2_table_size=13,
                           base_resolution=4, per_level_scale=2.0)
T_CFG = thg.HashGridConfig(n_levels=6, n_features=2, log2_table_size=13,
                           base_resolution=4, per_level_scale=2.0)
BF16_ULP = 2.0 ** -8


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (6, 1 << 13, 2)).astype(np.float32)


def _ray_stream(n_rays=8, k=256, seed=2):
    """dt_min-lattice ray-ordered samples (the 'runs' dedup's premise)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.1
    d = -o + rng.normal(size=(n_rays, 3)) * 0.05
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = 0.6 + np.arange(k) * 2.0 * np.sqrt(3.0) / 1024.0
    pts = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)
    return np.clip(pts * 0.4 + 0.5, 1e-3, 1 - 1e-3).astype(np.float32)


@pytest.mark.parametrize("scale,log2_T", [(0.5, 19), (0.5, 12), (1.0, 15)])
def test_level_config_and_addrs_equal_jax(scale, log2_T):
    jc = jhg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T)
    tc = thg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T)
    assert tc.per_level_scale == jc.per_level_scale
    np.testing.assert_array_equal(tc.level_scales(), jc.level_scales())
    np.testing.assert_array_equal(tc.level_resolutions(),
                                  jc.level_resolutions())
    for cj, ct in ((J_CFG, T_CFG), (jc, tc)):
        ja = [tuple(vars(a).values()) for a in jb3.brick3_addrs(cj)]
        ta = [tuple(vars(a).values()) for a in tb3.brick3_addrs(ct)]
        assert ja == ta
    assert {a.dense for a in tb3.brick3_addrs(T_CFG)} == {True, False}
    assert tb3._OFFS3 == jb3._OFFS3


@pytest.mark.parametrize("cfgs", [(J_CFG, T_CFG), (
    jhg.HashGridConfig.for_scene_scale(0.5),
    thg.HashGridConfig.for_scene_scale(0.5))])
def test_row_ids_exactly_equal(cfgs):
    jc, tc = cfgs
    R = tc.table_size // tb3.LANES
    rng = np.random.default_rng(1)
    p = rng.integers(0, 520, size=(3, 4000)).astype(np.int32)
    p[:, :3] = [[0, 519, 7], [0, 519, 300], [0, 519, 12]]
    for ja, ta in zip(jb3.brick3_addrs(jc), tb3.brick3_addrs(tc)):
        if ta.dense:        # in-range patch coords of a dense level
            q = p % ta.np_
        else:
            q = p
        ref = np.asarray(jb3._brick3_row(ja, *map(jnp.asarray, q), R))
        got = tb3._brick3_row(ta, *map(torch.from_numpy, q), R)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
        assert got.max() < R


def test_geometry_exactly_equal_jitted_reference():
    x = np.random.default_rng(3).uniform(0, 1, (5000, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.125]]
    levels = list(range(6))
    ref = jax.jit(lambda v: jhb._geometry(v, J_CFG, levels))(x)
    got = tb3._geometry(torch.from_numpy(x), T_CFG, levels)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pack_and_unpack_bit_layout():
    table = _table()
    ref = jax.lax.bitcast_convert_type(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.uint32
    ).reshape(-1, 128)
    got = tb3.pack_brick3_table(torch.from_numpy(table))
    assert got.shape == (6 * 64, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))
    lo, hi = tb3._unpack_bf16(got)
    tq = torch.from_numpy(table).to(torch.bfloat16).reshape(-1, 128, 2)
    assert torch.equal(lo, tq[..., 0]) and torch.equal(hi, tq[..., 1])


def test_ref_matches_jax_ref_f32():
    table = _table(4)
    x = np.random.default_rng(5).uniform(0, 1, (700, 3)).astype(np.float32)
    ref = jax.jit(lambda t, v: jb3.hashgrid_encode_brick3_ref(
        t, v, J_CFG, jnp.float32))(table, x)
    got = tb3.hashgrid_encode_brick3_ref(torch.from_numpy(table),
                                         torch.from_numpy(x), T_CFG)
    # same gathers and weights; XLA may contract a0 + w * t into an fma
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_forward_within_one_bf16_ulp_of_jax_plain():
    table = _table(6)
    x = np.random.default_rng(7).uniform(0, 1, (1500, 3)).astype(np.float32)
    ref = jax.jit(lambda t, v: jb3.hashgrid_encode_brick3_fwd_impl(
        t, v, J_CFG, "plain"))(table, x)
    ref = np.asarray(ref.astype(jnp.float32))
    got = tb3.hashgrid_encode_brick3_fwd_impl(
        torch.from_numpy(table), torch.from_numpy(x), T_CFG, "plain")
    assert got.shape == (1500, 12) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    # both sum the 8 weight x value products in float32 and round once to
    # bf16; the reference reduces over 128 lanes in its own order, so a
    # sum that lands near a rounding boundary may round one ulp apart
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.frexp(mag)[1] - 8.0)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() > 0.99


def test_forward_matches_jax_runs_mode_on_ray_stream():
    """B >= 1024 ray-ordered samples: the reference's 'runs' mode takes the
    Pallas extract kernel on every level (run cap <= 0.55 x 1024)."""
    table = _table(8)
    x = _ray_stream()
    assert x.shape[0] >= jb3.RUN_BLOCK
    for a in jb3.brick3_addrs(J_CFG):
        assert jb3._run_cap(a.res, jb3.RUN_BLOCK) <= int(
            jb3.RUN_BLOCK * jb3.RUN_MAX_FRAC)
    ref = jax.jit(lambda t, v: jb3.hashgrid_encode_brick3_fwd_impl(
        t, v, J_CFG, "runs"))(table, x)
    got = tb3.hashgrid_encode_brick3_fwd_impl(
        torch.from_numpy(table), torch.from_numpy(x), T_CFG, "runs")
    # the reference's extract kernel rounds the trilinear weights through
    # bf16 (its 'runs' fast path); the JAX suite's own tolerance for it
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-3)


def test_forward_matches_f32_golden_path():
    table = _table(9)
    tq = torch.from_numpy(table).to(torch.bfloat16).float()
    x = torch.from_numpy(
        np.random.default_rng(10).uniform(0, 1, (900, 3)).astype(np.float32))
    ref = tb3.hashgrid_encode_brick3_ref(tq, x, T_CFG)
    got = tb3.hashgrid_encode_brick3_fwd_impl(torch.from_numpy(table), x,
                                              T_CFG).float()
    # same f32 sums, then one rounding to bf16: half an ulp, which is at
    # most 2^-8 of the value
    assert ((got - ref).abs() <= BF16_ULP * ref.abs()).all()


def test_encode_dispatch_modes_and_refusals():
    cfg = MNGPConfig(scale=0.5, grid_size=32, n_levels=4, log2_T=12,
                     compute_dtype="bfloat16", hash_impl="brick3")
    gen = torch.Generator().manual_seed(0)
    params = {"hash_table": thg.init_hashgrid_table(gen, cfg.hash,
                                                    device="cpu")}
    state = {"xyz_min": -0.5 * torch.ones(3), "xyz_max": 0.5 * torch.ones(3)}
    x = torch.rand(300, 3, generator=gen) * 1.2 - 0.6     # some outside
    runs = _encode(params, state, cfg, x)
    plain = _encode(params, state, cfg, x, impl="brick3_plain")
    auto = _encode(params, state, cfg, x, impl="auto")
    assert torch.equal(runs, plain) and torch.equal(runs, auto)
    assert runs.shape == (300, 8)
    # every other family now encodes (tests/test_torch_hashgrid_tcnn.py
    # holds each against JAX); brick3 in float32 is the 'dedup' encode
    for impl in ("xla", "dedup", "window", "slab", "brick", "sort"):
        assert _encode(params, state, cfg, x, impl=impl).shape == (300, 8)
    f32 = MNGPConfig(scale=0.5, grid_size=32, n_levels=4, log2_T=12,
                     hash_impl="brick3")
    assert torch.equal(_encode(params, state, f32, x),
                       _encode(params, state, f32, x, impl="dedup"))
    with pytest.raises(ValueError):
        tb3.hashgrid_encode_brick3_fwd_impl(params["hash_table"], x,
                                            cfg.hash, fw_mode="dedup")
    with pytest.raises(ValueError):
        _encode(params, state, cfg, x, impl="nope")
    unshared = MNGPConfig(scale=0.5, grid_size=32, n_levels=4, log2_T=12,
                          compute_dtype="bfloat16", shared_encoder=False)
    with pytest.raises(NotImplementedError):
        _encode(params, state, unshared, x)


@pytest.mark.parametrize("scale,log2_T", [(0.5, 19), (0.5, 12), (1.0, 15),
                                          (2.0, 13)])
def test_level_params_cached_equal_an_uncached_build(scale, log2_T):
    cfg = thg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T)
    got = tb3._level_params(cfg)
    again = thg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T)
    assert again is not cfg and tb3._level_params(again) is got
    fresh = tb3._level_params.__wrapped__(cfg)
    assert fresh is not got
    for name in ("scales", "nps", "dense"):
        a, b = getattr(got, name), getattr(fresh, name)
        assert a.dtype == b.dtype and not a.flags.writeable
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.scales, cfg.level_scales())
    addrs = tb3.brick3_addrs(cfg)
    assert got.nps.tolist() == [a.np_ for a in addrs]
    assert got.dense.tolist() == [int(a.dense) for a in addrs]
    assert got.ptrs == tuple(a.ctypes.data
                             for a in (got.scales, got.nps, got.dense))


def _tie_table(seed):
    """Every value halfway between two bf16 values."""
    bf = torch.from_numpy(_table(seed)).to(torch.bfloat16)
    return ((bf.view(torch.int16).to(torch.int32) << 16) | 0x8000).view(
        torch.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_plain_twin_reads_the_f32_table_as_the_packed_words(ties):
    """The training path's read of the f32 table (each corner rounded to
    bf16) gives the bits of the read of the packed words."""
    table = _tie_table(11) if ties else torch.from_numpy(_table(11))
    packed = tb3.pack_brick3_table(table)
    if ties:
        lo, _ = tb3._unpack_bf16(packed.reshape(-1))
        up = lo.float().abs() > table[..., 0].reshape(-1).abs()
        assert up.any() and (~up).any()      # rounded to even, both ways
    rng = np.random.default_rng(12)
    x = torch.from_numpy(np.concatenate([
        _ray_stream(), rng.uniform(0, 1, (999, 3)).astype(np.float32)]))
    ref = tb3._encode_plain(packed, x, T_CFG)
    assert torch.equal(tb3._encode_plain(table, x, T_CFG), ref)
    assert torch.equal(
        tb3.hashgrid_encode_brick3_fwd_impl(table, x, T_CFG), ref)
    assert torch.equal(tb3.hashgrid_encode_brick3_fwd_impl(
        table, x, T_CFG, packed=packed), ref)


@pytest.mark.parametrize("impl,mode", [("brick3_plain", "plain"),
                                       ("brick3", "runs")])
def test_training_forward_without_a_packed_table_matches_jax(impl, mode):
    """The encode as the training step calls it (encode_dispatch, the
    table requiring grad, no packed table) against the reference's
    forward in the same mode."""
    table = _table(13)
    x = _ray_stream(seed=14)
    ref = jax.jit(lambda t, v: jb3.hashgrid_encode_brick3_fwd_impl(
        t, v, J_CFG, mode))(table, x)
    ref = np.asarray(ref.astype(jnp.float32))
    tt = torch.from_numpy(table).requires_grad_()
    got = thg.encode_dispatch(tt, torch.from_numpy(x), T_CFG,
                              torch.bfloat16, impl)
    assert got.requires_grad and got.dtype == torch.bfloat16
    with torch.no_grad():
        packed = tb3.pack_brick3_table(tt)
        assert torch.equal(got, tb3.hashgrid_encode_brick3_fwd_impl(
            tt, torch.from_numpy(x), T_CFG, mode, packed=packed))
    got = got.detach().float().numpy()
    if mode == "plain":
        # as test_forward_within_one_bf16_ulp_of_jax_plain
        mag = np.maximum(np.abs(got), np.abs(ref))
        assert (np.abs(got - ref) <= np.exp2(np.frexp(mag)[1] - 8.0)).all()
    else:
        # as test_forward_matches_jax_runs_mode_on_ray_stream
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3)
