"""PyTorch port vs the JAX package, the brick family: the level classes,
the u32 row addressing, the forward, the backward's stream and the table
gradient (the plain twin of the `brick_table_grad` kernel on the CPU)
against the reference's exact path and its default (f16 payloads, bf16
matmul operands).

The JAX side is jitted; its brick kernel runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import hashgrid as jhg
from radnerf_tpu.ops import hashgrid_brick as jbr
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_brick as tbr

from .test_torch_hashgrid_tcnn import (
    COLLISION_CASES, J_CFG, T_CFG, collision_inputs, f16_pack_tol,
    f32_order_tol, inputs, table, term_stats,
)

torch.set_num_threads(1)


def _stream(x, g, tc):
    key, vals = tbr._bwd_streams(torch.from_numpy(x), torch.from_numpy(g),
                                 tc)
    return key, torch.stack(vals)


@pytest.mark.parametrize("scale,log2_T", [(None, None), (0.5, 19),
                                          (1.0, 15)])
def test_brick_addrs_equal_jax(scale, log2_T):
    if scale is None:
        jc, tc = J_CFG, T_CFG
    else:
        jc = jhg.HashGridConfig.for_scene_scale(scale,
                                                log2_table_size=log2_T)
        tc = thg.HashGridConfig.for_scene_scale(scale,
                                                log2_table_size=log2_T)
    ja = [tuple(vars(a).values()) for a in jbr.brick_addrs(jc)]
    ta = [tuple(vars(a).values()) for a in tbr.brick_addrs(tc)]
    assert ja == ta
    assert {a.dense for a in tbr.brick_addrs(tc)} == {True, False}
    assert tbr._OFFS == jbr._OFFS


def test_rows_and_lanes_bit_equal():
    R = T_CFG.table_size // tbr.LANES
    rng = np.random.default_rng(1)
    p = rng.integers(0, 140, (3, 5000)).astype(np.int32)
    p[:, :3] = [[0, 139, 7], [0, 139, 60], [0, 139, 3]]
    for ja, ta in zip(jbr.brick_addrs(J_CFG), tbr.brick_addrs(T_CFG)):
        if ta.dense:          # in-range patches and slices of a dense level
            q = np.stack([p[0] % ta.npx, p[1] % ta.npy, p[2] % (ta.res + 2)])
        else:
            q = p
        ref = np.asarray(jbr._brick_row(ja, *map(jnp.asarray, q), R))
        got = tbr._brick_row(ta, *map(torch.from_numpy, q), R)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
        assert got.max() < R
    jl = jbr._patch_lane(jnp.asarray(p[0]), jnp.asarray(p[1]))
    tl = tbr._patch_lane(torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_forward_within_one_bf16_ulp_of_jitted_jax():
    x, _ = inputs(6, seed=2)
    tb = table(3)
    ref = jax.jit(lambda t, v: jbr.hashgrid_encode_brick_fwd_impl(
        t, v, J_CFG))(tb, x)
    ref = np.asarray(ref.astype(jnp.float32))
    got = tbr.hashgrid_encode_brick_fwd_impl(torch.from_numpy(tb),
                                             torch.from_numpy(x), T_CFG)
    assert got.dtype == torch.bfloat16 and got.shape == (2048, 12)
    got = got.float().numpy()
    # the same four f32 products per z-row, summed in f32 and rounded once
    # to bf16; the reference reduces its 128-lane multi-hot row in XLA's
    # own order, so a sum near a rounding boundary may round one ulp apart
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.frexp(mag)[1] - 8.0)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() > 0.999


def test_backward_stream_bit_equal():
    x, g = inputs(6, n=1000, seed=4)
    jk, jv = jax.jit(lambda a, b: jbr._bwd_streams(a, b, J_CFG))(x, g)
    tk, tv = tbr._bwd_streams(torch.from_numpy(x), torch.from_numpy(g),
                              T_CFG)
    assert tk.shape == (6, 2000) and tk.dtype == torch.int32 and len(tv) == 8
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tk.max() % 128) <= 9 + 11 * 9      # lane0 + 12 < 128


@pytest.mark.parametrize("pack_f16", [False, True])
def test_table_grad_matches_jax(pack_f16):
    x, g = inputs(6, n=1024, seed=5)
    g[500:700] = 0.0                            # masked samples
    ref = np.asarray(jax.jit(lambda a, b: jbr.hashgrid_table_grad_brick(
        a, b, J_CFG, interpret=True, pack_f16=pack_f16))(x, g))
    got = tbr.hashgrid_table_grad_brick(torch.from_numpy(x),
                                        torch.from_numpy(g), T_CFG).numpy()
    assert got.shape == (6, T_CFG.table_size, 2)
    keys, vals = _stream(x, g, T_CFG)
    count, abs_sum = term_stats("brick_table_grad", keys, vals,
                                T_CFG.table_size)
    if pack_f16:
        # f16 payloads (scaled), then bf16 matmul operands: 2^-11 and
        # 2^-8 relative per term (with their cross term)
        tol = f16_pack_tol(count, abs_sum, vals,
                           rel=2.0**-11 + 2.0**-8 * (1 + 2.0**-11))
        assert np.abs(got - ref).max() > 0
    else:
        tol = f32_order_tol(count, abs_sum)
    assert (np.abs(got - ref) <= tol).all()
    assert (count > 1).sum() > 500


@pytest.mark.parametrize("case", COLLISION_CASES)
def test_table_grad_on_collision_streams_matches_jax(case):
    x, g = collision_inputs(case, 6)
    ref = np.asarray(jax.jit(lambda a, b: jbr.hashgrid_table_grad_brick(
        a, b, J_CFG, interpret=True, pack_f16=False))(x, g))
    got = tbr.hashgrid_table_grad_brick(torch.from_numpy(x),
                                        torch.from_numpy(g), T_CFG).numpy()
    keys, vals = _stream(x, g, T_CFG)
    count, abs_sum = term_stats("brick_table_grad", keys, vals,
                                T_CFG.table_size)
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()
    assert count.max() >= 8


def test_sorted_table_grad_brick_takes_any_order():
    rng = np.random.default_rng(6)
    L, n, T = 2, 3000, 1 << 10
    rows = rng.integers(0, T // 128, (L, n))
    lane0 = rng.integers(0, 9, (L, n)) + 11 * rng.integers(0, 9, (L, n))
    sk = torch.from_numpy((rows * 128 + lane0).astype(np.int32))
    vals = [torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
            for _ in range(8)]
    got = tbr.sorted_table_grad_brick(sk, vals, T).numpy()
    order = np.argsort(sk.numpy(), axis=1, kind="stable")
    ref = np.asarray(jax.jit(lambda k, *v: jbr.sorted_table_grad_brick(
        k, v, T, interpret=True, exact=True))(
        np.take_along_axis(sk.numpy(), order, 1),
        *(np.take_along_axis(v.numpy(), order, 1) for v in vals)))
    count, abs_sum = term_stats("brick_table_grad", sk, torch.stack(vals), T)
    assert count.max() > 5
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()


def test_encode_brick_autograd_and_refusals():
    x, g = inputs(6, n=600, seed=7)
    tb = torch.tensor(table(8), requires_grad=True)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    out = tbr.hashgrid_encode_brick(tb, tx, T_CFG)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tbr.hashgrid_encode_brick_fwd_impl(
        tb.detach(), tx, T_CFG))
    (grad,) = torch.autograd.grad((out.float() * tg).sum(), tb)
    # the output is bf16, so its gradient is tg rounded to bf16
    gb = tg.to(torch.bfloat16).float()
    assert torch.equal(grad, tbr.hashgrid_table_grad_brick(tx, gb, T_CFG))
    with pytest.raises(ValueError):
        tbr.hashgrid_encode_brick(tb, tx, T_CFG, torch.float32)
