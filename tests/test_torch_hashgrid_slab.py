"""PyTorch port vs the JAX package, the slab family: the level classes,
the u32 addressing (_psi, _qm), both forwards ('plain' and the dedup
forward over the slab addressing), the backward's pair stream and the
table gradient (the plain twin of the `slab_table_grad` kernel on the
CPU), and the boundary corner whose entry lands on T.

The JAX side is jitted; its pair kernel runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import hashgrid as jhg
from radnerf_tpu.ops import hashgrid_dedup as jdd
from radnerf_tpu.ops import hashgrid_slab as jsl
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_dedup as tdd
from radnerf_tpu_torch.ops import hashgrid_slab as tsl

from .test_torch_hashgrid_tcnn import (
    COLLISION_CASES, J_CFG, T_CFG, collision_inputs, f16_pack_tol,
    f32_order_tol, inputs, ray_stream, table, term_stats,
)

torch.set_num_threads(1)


def _pair_stream(key, planes):
    v0e, v0o, v1e, v1o = planes
    return key, torch.stack([v0e, v1e, v0o, v1o])


@pytest.mark.parametrize("scale,log2_T", [(None, None), (0.5, 19),
                                          (0.5, 12), (1.0, 15)])
def test_level_addrs_equal_jax(scale, log2_T):
    if scale is None:
        jc, tc = J_CFG, T_CFG
    else:
        jc = jhg.HashGridConfig.for_scene_scale(scale,
                                                log2_table_size=log2_T)
        tc = thg.HashGridConfig.for_scene_scale(scale,
                                                log2_table_size=log2_T)
    ja = [tuple(vars(a).values()) for a in jsl.level_addrs(jc)]
    ta = [tuple(vars(a).values()) for a in tsl.level_addrs(tc)]
    assert ja == ta
    if scale is None:
        assert {a.dense for a in tsl.level_addrs(tc)} == {True, False}
        assert {a.C for a in tsl.level_addrs(tc) if a.dense} == {128, 9, 17}


def test_psi_and_qm_bit_equal():
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2**31 - 1, 5000).astype(np.int32)
    z[:3] = [0, 1, 2**31 - 2]
    for level in (0, 3, 15):
        ref = np.asarray(jsl._psi(jnp.asarray(z), level))
        got = tsl._psi(torch.from_numpy(z), level)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    p = rng.integers(0, 130, (3, 5000)).astype(np.int32)
    for ja, ta in zip(jsl.level_addrs(J_CFG), tsl.level_addrs(T_CFG)):
        q = p % (ta.res + 1) if ta.dense else p
        for zc in (0, 1):
            jq, jm = jsl._qm(ja, *map(jnp.asarray, q), zc)
            tq, tm = tsl._qm(ta, *map(torch.from_numpy, q), zc)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_plain_forward_equal_jitted_jax():
    x, _ = inputs(6, seed=1)
    tb = table(2)
    ref = jax.jit(lambda t, v: jsl.hashgrid_encode_slab_fwd_impl(
        t, v, J_CFG))(tb, x)
    got = tsl.hashgrid_encode_slab_fwd_impl(torch.from_numpy(tb),
                                            torch.from_numpy(x), T_CFG)
    assert got.dtype == torch.bfloat16 and got.shape == (2048, 12)
    # per corner w_z w_y w_x times the bf16 value, added to an f32 sum
    # with one rounding (XLA's fused multiply-add), rounded to bf16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_dedup_forward_over_slab_addressing_equal_jitted_jax():
    x = ray_stream(seed=3)
    tb = table(4)
    ref = jax.jit(lambda t, v: jdd.hashgrid_encode_dedup_fwd_impl(
        t, v, J_CFG, jnp.bfloat16, addr="slab"))(tb, x)
    got = tdd.hashgrid_encode_dedup_fwd_impl(
        torch.from_numpy(tb), torch.from_numpy(x), T_CFG, torch.bfloat16,
        addr="slab")
    # weights rounded to bf16 first (not 'plain''s function), then the
    # f32 sum of exact bf16 products, rounded once
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    plain = tsl.hashgrid_encode_slab_fwd_impl(torch.from_numpy(tb),
                                              torch.from_numpy(x), T_CFG)
    assert not torch.equal(plain, got)


def test_backward_stream_bit_equal():
    x, g = inputs(6, n=1000, seed=5)           # padded to 1024 on both
    jk, jv = jax.jit(lambda a, b: jsl._bwd_streams(a, b, J_CFG))(x, g)
    tk, tv = tsl._bwd_streams(torch.from_numpy(x), torch.from_numpy(g),
                              T_CFG)
    assert tk.shape == (6, 4 * 1024) and tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("pack_f16", [False, True])
def test_table_grad_matches_jax(pack_f16):
    x, g = inputs(6, n=1024, seed=6)
    g[:200] = 0.0                              # masked samples
    ref = np.asarray(jax.jit(lambda a, b: jsl.hashgrid_table_grad_slab(
        a, b, J_CFG, interpret=True, pack_f16=pack_f16))(x, g))
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = tsl.hashgrid_table_grad_slab(tx, tg, T_CFG).numpy()
    assert got.shape == (6, T_CFG.table_size, 2)
    keys, vals = _pair_stream(*tsl._bwd_streams(tx, tg, T_CFG))
    count, abs_sum = term_stats("slab_table_grad", keys, vals,
                                T_CFG.table_size)
    if pack_f16:
        # the reference's default rounds the terms to f16 (scaled)
        tol = f16_pack_tol(count, abs_sum, vals)
        assert np.abs(got - ref).max() > 0
    else:
        tol = f32_order_tol(count, abs_sum)
    assert (np.abs(got - ref) <= tol).all()
    assert (count > 1).sum() > 500


@pytest.mark.parametrize("case", COLLISION_CASES)
def test_table_grad_on_collision_streams_matches_jax(case):
    x, g = collision_inputs(case, 6)           # padded to 1024 on both
    ref = np.asarray(jax.jit(lambda a, b: jsl.hashgrid_table_grad_slab(
        a, b, J_CFG, interpret=True, pack_f16=False))(x, g))
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = tsl.hashgrid_table_grad_slab(tx, tg, T_CFG).numpy()
    keys, vals = _pair_stream(*tsl._bwd_streams(tx, tg, T_CFG))
    count, abs_sum = term_stats("slab_table_grad", keys, vals,
                                T_CFG.table_size)
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()
    assert count.max() >= 8


def boundary_point(tc):
    """A position whose (x+1, y+1) corner of z-corner 0 lands on entry T
    at the finest (hashed) level: x at lane m = C - 1 and y chosen so
    that q = R - 2. Returns it and the level."""
    a = tsl.level_addrs(tc)[-1]
    assert not a.dense and a.res > a.C - 1
    scale = float(tc.level_scales()[-1])
    xi, zi = a.C - 1, 5
    yi = int((a.R - 2 - int(tsl._psi(torch.tensor([zi]), a.level)[0])
              - (xi >> a.log2C)) % (a.R - 1))
    pos = np.array([xi + 0.75, yi + 0.6, zi + 0.7])
    x = ((pos - 0.5) / scale).astype(np.float32)[None]
    xi_t, yi_t, zi_t, _ = thg._geometry(torch.from_numpy(x), tc,
                                        [a.level])
    q, m = tsl._qm(a, xi_t[0], yi_t[0], zi_t[0], 0)
    assert int((q[0] + 1) * a.C + m[0] + 1) == tc.table_size
    return x, a.level


def test_boundary_corner_reads_T_minus_1_and_its_gradient_is_dropped():
    x, level = boundary_point(T_CFG)
    x = np.repeat(x, 128, axis=0)              # the stream is 128-padded
    tb = table(7)
    for fwd_j, fwd_t in (
            (lambda t, v: jsl.hashgrid_encode_slab_fwd_impl(t, v, J_CFG),
             lambda t, v: tsl.hashgrid_encode_slab_fwd_impl(t, v, T_CFG)),
            (lambda t, v: jdd.hashgrid_encode_dedup_fwd_impl(
                t, v, J_CFG, jnp.bfloat16, addr="slab"),
             lambda t, v: tdd.hashgrid_encode_dedup_fwd_impl(
                 t, v, T_CFG, torch.bfloat16, addr="slab"))):
        ref = jax.jit(fwd_j)(tb, x).astype(jnp.float32)
        got = fwd_t(torch.from_numpy(tb), torch.from_numpy(x))
        assert torch.isfinite(got.float()).all()
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref))
    g = np.ones((128, 12), np.float32)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    keys, planes = tsl._bwd_streams(tx, tg, T_CFG)
    T = T_CFG.table_size
    edge = keys[level] == T - 1
    assert edge.any() and (planes[1][level][edge] != 0).all()   # x-odd
    got = tsl.hashgrid_table_grad_slab(tx, tg, T_CFG).numpy()
    ref = np.asarray(jax.jit(lambda a, b: jsl.hashgrid_table_grad_slab(
        a, b, J_CFG, interpret=True, pack_f16=False))(x, g))
    count, abs_sum = term_stats("slab_table_grad",
                                *_pair_stream(keys, planes), T)
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()
    # entry T - 1 holds the x-even halves only: the k + 1 == T halves
    # went nowhere
    even = planes[0][level][edge].double().sum().item()
    np.testing.assert_allclose(got[level, T - 1, 0], even, rtol=1e-6)


def test_encode_slab_autograd_and_refusals():
    x, g = inputs(6, n=600, seed=8)
    tb = torch.tensor(table(9), requires_grad=True)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    for mode in ("dedup", "plain"):
        out = tsl.hashgrid_encode_slab(tb, tx, T_CFG, fw_mode=mode)
        assert out.dtype == torch.bfloat16
        (grad,) = torch.autograd.grad((out.float() * tg).sum(), tb)
        # the output is bf16, so its gradient is tg rounded to bf16
        gb = tg.to(torch.bfloat16).float()
        want = tsl.hashgrid_table_grad_slab(tx, gb, T_CFG)
        assert torch.equal(grad, want)
    with pytest.raises(ValueError):
        tsl.hashgrid_encode_slab(tb, tx, T_CFG, torch.float32)
    with pytest.raises(ValueError):
        tsl.hashgrid_encode_slab(tb, tx, T_CFG, fw_mode="runs")
