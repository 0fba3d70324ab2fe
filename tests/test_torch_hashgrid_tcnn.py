"""PyTorch port vs the JAX package, the tcnn-hash families ('xla', 'sort',
'window', 'dedup', 'pallas'): corner rows and weights, the f32 and bf16
encodes, the dedup forward, the four table-gradient wrappers (the plain
twin of the `tcnn_table_grad` kernel on the CPU), `encode_dispatch` for
every impl name, and the impl helpers.

The JAX side is jitted; its Pallas backwards run in interpret mode
(explicit interpret=True; through `encode_dispatch` by patching the
family entry points, whose backwards are otherwise built with
interpret=False, which the CPU refuses). `hash_impl` is pinned on both
sides ('auto' differs by design: brick3 in the port)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radnerf_tpu.ops.hashgrid_brick as jbr
import radnerf_tpu.ops.hashgrid_brick3 as jb3
import radnerf_tpu.ops.hashgrid_dedup as jdd
import radnerf_tpu.ops.hashgrid_pallas as jhp
import radnerf_tpu.ops.hashgrid_slab as jsl
import radnerf_tpu.ops.hashgrid_sort as jhs
import radnerf_tpu.ops.hashgrid_window as jhw
from radnerf_tpu.ops import hashgrid as jhg
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_dedup as tdd
from radnerf_tpu_torch.ops import hashgrid_pallas as thp
from radnerf_tpu_torch.ops import hashgrid_sort as ths
from radnerf_tpu_torch.ops import hashgrid_window as thw
from radnerf_tpu_torch.ops.stream_table_grad import (
    stream_table_grad, stream_terms,
)

torch.set_num_threads(1)

# res 4..128 over 6 levels: dense AND hashed classes (the JAX suite's CFG)
CFG_KW = dict(n_levels=6, n_features=2, log2_table_size=13,
              base_resolution=4, per_level_scale=2.0)
J_CFG, T_CFG = jhg.HashGridConfig(**CFG_KW), thg.HashGridConfig(**CFG_KW)
U32 = 2.0 ** -24                 # unit roundoff of float32
IMPLS = ("xla", "sort", "window", "dedup", "pallas", "slab", "slab_plain",
         "brick", "brick3", "brick3_plain")


def cfg_pairs():
    return [(J_CFG, T_CFG),
            (jhg.HashGridConfig.for_scene_scale(0.5, log2_table_size=12),
             thg.HashGridConfig.for_scene_scale(0.5, log2_table_size=12))]


def inputs(n_levels, n=2048, seed=0):
    """Uniform positions (the corners included) and an output gradient."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.125]]
    g = rng.normal(size=(n, 2 * n_levels)).astype(np.float32)
    return x, g


COLLISION_CASES = ("one cell, positive gradients",
                   "runs of 8, zero-gradient members",
                   "rays of 64, ragged length")


def collision_inputs(case, n_levels, n=1000, seed=11):
    """Positions and an output gradient whose table terms collide (the
    streams the card's warp aggregation is made for): every sample on one
    point with positive gradients; runs of 8 samples on one point with
    every third gradient zero; rays of 64 samples 2^-10 apart, cut to a
    length n that is a multiple of neither 64 nor 128."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, 2 * n_levels)).astype(np.float32)
    k = np.arange(n)
    if case == COLLISION_CASES[0]:
        x = np.repeat(rng.uniform(0, 1, (1, 3)), n, axis=0)
        g = np.abs(g)
    elif case == COLLISION_CASES[1]:
        x = rng.uniform(0, 1, (-(-n // 8), 3))[k // 8]
        g[k % 3 == 0] = 0.0
    else:
        d = rng.normal(size=(-(-n // 64), 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = 0.25 + 0.5 * rng.uniform(0, 1, d.shape)
        x = np.clip(o[k // 64] + d[k // 64] * (k % 64)[:, None] * 2.0**-10,
                    0.0, 1.0)
    return x.astype(np.float32), g


def ray_stream(n_rays=8, k=256, seed=2):
    """dt_min-lattice ray-ordered samples (the dedup merge's premise) on a
    2^-16 lattice: with the integer level scales of CFG_KW, x * scale is
    exact in f32, so XLA's choice to contract x * scale + 0.5 into a fused
    multiply-add on some axes of the dedup layout and not on others
    cannot move a position."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.1
    d = -o + rng.normal(size=(n_rays, 3)) * 0.05
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = 0.6 + np.arange(k) * 2.0 * np.sqrt(3.0) / 1024.0
    pts = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)
    pts = np.clip(pts * 0.4 + 0.5, 1e-3, 1 - 1e-3)
    return (np.round(pts * 2**16) / 2**16).astype(np.float32)


def table(seed=1, shape=(6, 1 << 13, 2)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def term_stats(name, keys, vals, T):
    """Per table entry of a stream: the number of its nonzero terms and
    sum |term|, (L, T, 2) float64, from the port's own term list."""
    L = keys.shape[0]
    flat, terms = stream_terms(name, keys, vals.double(), T)
    count = torch.zeros((L * T, 2), dtype=torch.float64)
    count.index_add_(0, flat, (terms != 0).double())
    abs_sum = torch.zeros((L * T, 2), dtype=torch.float64)
    abs_sum.index_add_(0, flat, terms.abs())
    return count.reshape(L, T, 2).numpy(), abs_sum.reshape(L, T, 2).numpy()


def f32_order_tol(count, abs_sum):
    """Two float32 sums of the same n terms in different orders differ by
    at most 2 (n - 1) u sum|terms|; a tiny floor for empty entries."""
    return 2 * np.maximum(count - 1, 1) * U32 * abs_sum + 1e-30


def f16_pack_tol(count, abs_sum, vals, rel=2.0 ** -11):
    """The reference's pack_f16 default against the exact gradient: each
    term v of level l is scaled by s_l = 2^(14 - e_l) (amax_l = m 2^e_l
    over the level's planes) and rounded to f16: |dv| <= 2^-11 |v| for a
    normal f16 and <= 2^-25 / s_l below 2^-14 (half the subnormal step);
    `rel` > 2^-11 adds later roundings of the same terms. Then the f32
    sums of the rounded terms in their order, and the exact power-of-two
    unscale."""
    amax = vals.abs().amax(dim=(0, 2)).double().numpy()           # (L,)
    e = np.frexp(amax)[1]
    s = np.where(amax > 0, np.exp2(14.0 - e), 1.0)[:, None, None]
    quant = rel * abs_sum + count * 2.0 ** -25 / s
    return quant + f32_order_tol(count, abs_sum * (1 + rel) + quant)


@pytest.mark.parametrize("cfgs", cfg_pairs())
def test_corner_rows_and_weights_bit_equal(cfgs):
    jc, tc = cfgs
    assert tc.level_is_dense().tolist() == jc.level_is_dense().tolist()
    assert set(tc.level_is_dense().tolist()) == {True, False}
    x, _ = inputs(tc.n_levels)
    for jf, tf in ((jhg.hashgrid_indices_cm, thg.hashgrid_indices_cm),
                   (jhg.hashgrid_indices, thg.hashgrid_indices)):
        ji, jw = jax.jit(lambda v: jf(v, jc))(x)
        ti, tw = tf(torch.from_numpy(x), tc)
        assert ti.dtype == torch.int32 and tw.dtype == torch.float32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # (w_x w_y) w_z in both; the reference's jnp.prod may take any
        # order (one f32 ulp per weight), and takes this one
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(ti.max()) < tc.table_size


def test_dense_level_wraps_at_the_far_corner():
    """x = 1 on a dense level: the +1 corner's index exceeds T and is
    masked with T - 1, as in the reference."""
    kw = dict(n_levels=1, log2_table_size=9, base_resolution=8)
    jc, tc = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    assert tc.level_is_dense().all()
    x = np.ones((128, 3), np.float32)
    ji, _ = jax.jit(lambda v: jhg.hashgrid_indices_cm(v, jc))(x)
    ti, _ = thg.hashgrid_indices_cm(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    res = int(tc.level_resolutions()[0])
    c = int(np.floor(tc.level_scales()[0] + 0.5)) + 1     # the far corner
    assert c + res * (c + res * c) >= tc.table_size       # it did wrap


@pytest.mark.parametrize("cfgs", cfg_pairs())
def test_encode_f32_within_f32_ulps_and_bf16_equal(cfgs):
    jc, tc = cfgs
    x, _ = inputs(tc.n_levels, seed=3)
    tb = table(4, (tc.n_levels, tc.table_size, 2))
    tx, tt = torch.from_numpy(x), torch.from_numpy(tb)
    ref = np.asarray(jax.jit(lambda t, v: jhg.hashgrid_encode(
        t, v, jc, jnp.float32))(tb, x))
    got = thg.hashgrid_encode(tt, tx, tc)
    assert got.dtype == torch.float32 and got.shape == (2048, 2 * tc.n_levels)
    # the same 8 f32 products; XLA sums them in its own order (and may
    # fuse a product into the add): within 4 ulp of the largest |term|
    # sum, which is <= 1 (weights sum to 1, |table| <= 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4 * U32)
    for jf in (lambda t, v: jhg.hashgrid_encode(t, v, jc, jnp.bfloat16),
               lambda t, v: jhg.hashgrid_encode_packed(t, v, jc)):
        ref = jax.jit(jf)(tb, x).astype(jnp.float32)
        # bf16 x bf16 products are exact in f32; both sum them in f32 and
        # round once to bf16 (as jitted XLA does)
        for got in (thg.hashgrid_encode(tt, tx, tc, torch.bfloat16),
                    thg.hashgrid_encode_packed(tt, tx, tc)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref))


@pytest.mark.parametrize("dtypes", [(jnp.bfloat16, torch.bfloat16),
                                    (jnp.float32, torch.float32)])
def test_dedup_forward_matches_jax(dtypes):
    jdt, tdt = dtypes
    x = ray_stream()
    tb = table(5)
    ref = np.asarray(jax.jit(lambda t, v: jdd.hashgrid_encode_dedup_fwd_impl(
        t, v, J_CFG, jdt))(tb, x).astype(jnp.float32))
    got = tdd.hashgrid_encode_dedup_fwd_impl(
        torch.from_numpy(tb), torch.from_numpy(x), T_CFG, tdt)
    assert got.dtype == tdt
    if tdt == torch.bfloat16:
        # the merge only reuses identical voxels' features: equal
        np.testing.assert_array_equal(got.float().numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4 * U32)
    # the reference took its merge path on some levels at this input
    caps = jdd.level_caps(J_CFG)
    assert min(caps) < jdd.BLOCK and tdd.level_caps(T_CFG) == caps
    assert tdd._group_levels(caps, 256) == jdd._group_levels(caps, 256)


def _tcnn_stream(x, g, tc):
    idx, w = thg.hashgrid_indices_cm(torch.from_numpy(x), tc)
    return thw.tcnn_stream(idx, w, torch.from_numpy(g))


# the four wrappers of the tcnn table gradient, and the reference of each
# (its exact path: pack_f16=False where the reference has the option)
def _ref_window(x, g, jc, pack_f16=False):
    idx, w = jhg.hashgrid_indices_cm(x, jc)
    return jhw.hashgrid_table_grad_window(idx, w, g, jc, interpret=True,
                                          pack_f16=pack_f16)


def _ref_pallas(x, g, jc):
    idx, w = jhg.hashgrid_indices(x, jc)
    return jhp.hashgrid_table_grad(idx, w, g, jc, interpret=True)


def _ref_sort(x, g, jc):
    idx, w = jhg.hashgrid_indices_cm(x, jc)
    return jhs.hashgrid_table_grad_sort(idx, w, g, jc)


def _ref_dedup(x, g, jc):
    return jdd.hashgrid_table_grad_dedup(x, g, jc, interpret=True)


def _port(name, x, g, tc):
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if name == "window":
        return thw.hashgrid_table_grad_window(
            *thg.hashgrid_indices_cm(tx, tc), tg, tc)
    if name == "pallas":
        return thp.hashgrid_table_grad(*thg.hashgrid_indices(tx, tc), tg, tc)
    if name == "sort":
        return ths.hashgrid_table_grad_sort(
            *thg.hashgrid_indices_cm(tx, tc), tg, tc)
    return tdd.hashgrid_table_grad_dedup(tx, tg, tc)


REFS = {"window": _ref_window, "pallas": _ref_pallas, "sort": _ref_sort,
        "dedup": _ref_dedup}


@pytest.mark.parametrize("name", list(REFS))
def test_table_grad_matches_jax_exact_path(name):
    x = ray_stream() if name == "dedup" else inputs(6, n=1024, seed=6)[0]
    g = np.random.default_rng(7).normal(size=(x.shape[0], 12)).astype(
        np.float32)
    g[100:300] = 0.0                      # masked samples add nothing
    ref = np.asarray(jax.jit(lambda a, b: REFS[name](a, b, J_CFG))(x, g))
    got = _port(name, x, g, T_CFG).numpy()
    assert got.shape == (6, T_CFG.table_size, 2) and got.dtype == np.float32
    count, abs_sum = term_stats("tcnn_table_grad",
                                *_tcnn_stream(x, g, T_CFG), T_CFG.table_size)
    # the same f32 products w * g, summed in another order
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()
    assert (count > 1).sum() > 500 and (got != 0).sum() > 1000


def test_table_grad_vs_jax_default_f16_packed_path():
    x, g = inputs(6, n=1024, seed=8)
    ref = np.asarray(jax.jit(lambda a, b: _ref_window(
        a, b, J_CFG, pack_f16=True))(x, g))
    got = _port("window", x, g, T_CFG).numpy()
    keys, vals = _tcnn_stream(x, g, T_CFG)
    count, abs_sum = term_stats("tcnn_table_grad", keys, vals,
                                T_CFG.table_size)
    assert (np.abs(got - ref) <= f16_pack_tol(count, abs_sum, vals)).all()
    # it is a real difference: the exact gradient is not the f16 one
    assert np.abs(got - ref).max() > 0


def test_window_table_grad_equals_plain_scatter_of_any_order():
    """The kernel contract: an unsorted stream, repeated rows; the result
    is the float64 sum of every term within the f32 order bound."""
    rng = np.random.default_rng(9)
    L, n, T = 3, 5000, 1 << 10
    sk = torch.from_numpy(rng.integers(0, 50, (L, n)).astype(np.int32))
    s0, s1 = (torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
              for _ in range(2))
    got = thw.sorted_table_grad_window(sk, s0, s1, T).numpy()
    exact = np.zeros((L, T, 2))
    for lvl in range(L):
        np.add.at(exact[lvl, :, 0], sk[lvl].numpy(), s0[lvl].double().numpy())
        np.add.at(exact[lvl, :, 1], sk[lvl].numpy(), s1[lvl].double().numpy())
    count, abs_sum = term_stats("tcnn_table_grad", sk, torch.stack([s0, s1]),
                                T)
    assert count.max() > 50
    assert (np.abs(got - exact) <= f32_order_tol(count, abs_sum)).all()
    ref = np.asarray(jax.jit(lambda a, b, c: jhw.sorted_table_grad_window(
        *jax.lax.sort((a, b, c), num_keys=1), T, interpret=True))(
        sk.numpy(), s0.numpy(), s1.numpy()))
    assert (np.abs(got - ref) <= f32_order_tol(count, abs_sum)).all()
    with pytest.raises(ValueError):
        stream_table_grad("tcnn_table_grad", sk,
                          torch.stack([s0, s1]).double(), T)
    with pytest.raises(ValueError):
        stream_table_grad("tcnn_scatter", sk, torch.stack([s0, s1]), T)


@pytest.fixture
def interpret(monkeypatch):
    """encode_dispatch imports the family entry points at call time: run
    their Pallas backwards in interpret mode."""
    for mod, name in ((jhw, "hashgrid_encode_window"),
                      (jdd, "hashgrid_encode_dedup"),
                      (jhp, "hashgrid_encode_fused"),
                      (jsl, "hashgrid_encode_slab"),
                      (jbr, "hashgrid_encode_brick"),
                      (jb3, "hashgrid_encode_brick3")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtypes", [(jnp.bfloat16, torch.bfloat16),
                                    (jnp.float32, torch.float32)])
def test_encode_dispatch_every_impl_matches_jax(interpret, impl, dtypes):
    """Forward and table gradient of encode_dispatch, both packages, each
    impl in bf16 and in f32 (brick3, brick and slab fall back to 'dedup'
    in f32 on both sides)."""
    jdt, tdt = dtypes
    kw = dict(n_levels=4, log2_table_size=11, base_resolution=4,
              per_level_scale=2.0)
    jc, tc = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    x = ray_stream(n_rays=2, k=512, seed=10)
    g = np.random.default_rng(11).normal(size=(x.shape[0], 8)).astype(
        np.float32)
    tb = table(12, (4, 1 << 11, 2))

    def jf(t):
        return jhg.encode_dispatch(t, x, jc, jdt, impl)

    ref = jax.jit(jf)(tb)
    ref_grad = jax.jit(jax.grad(lambda t: jnp.sum(
        jf(t).astype(jnp.float32) * g)))(tb)
    tt = torch.tensor(tb, requires_grad=True)
    got = thg.encode_dispatch(tt, torch.from_numpy(x), tc, tdt, impl)
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert got.dtype == tdt and got.shape == (x.shape[0], 8)
    ref = np.asarray(ref.astype(jnp.float32))
    if tdt == torch.float32:
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=4 * U32)
    elif impl == "brick3":
        # the reference's 'runs' kernel rounds its stencil weights through
        # bf16 (the JAX suite's own tolerance for it)
        np.testing.assert_allclose(got.detach().float().numpy(), ref,
                                   rtol=2e-2, atol=2e-3)
    else:
        # f32 sums rounded once to bf16 on both sides; brick's and
        # brick3_plain's references reduce their 128 lanes in XLA's order
        mag = np.maximum(np.abs(ref), np.abs(got.detach().float().numpy()))
        ulp = np.exp2(np.frexp(mag)[1] - 8.0)
        assert (np.abs(got.detach().float().numpy() - ref) <= ulp).all()
    # table gradients: the port's exact f32 one against the reference's
    # (f16-packed or quantized in bf16 for window/dedup/slab/brick/brick3,
    # exact for sort, pallas, and xla in f32): within 1% of the largest
    # entry
    ref_grad = np.asarray(ref_grad)
    scale = np.abs(ref_grad).max()
    assert scale > 0
    err = np.abs(tt.grad.numpy() - ref_grad)
    if impl == "xla" and tdt == torch.bfloat16:
        # the reference's autodiff takes g and w in bf16, rounds their
        # product to bf16 and adds the products into a bf16 table (unit
        # roundoff 2^-8): within (n + 2) 2^-8 sum|terms| per entry of n
        # terms, with 1% for second-order terms
        count, abs_sum = term_stats(
            "tcnn_table_grad", *_tcnn_stream(x, g, tc), tc.table_size)
        tol = 1.01 * (count + 2) * 2.0**-8 * abs_sum + 1e-30
        assert (err <= tol).all()
    else:
        assert err.max() <= 1e-2 * scale, impl


def test_impl_helpers_match_jax():
    for impl in IMPLS:
        assert thg.hash_family(impl) == jhg.hash_family(impl)
        assert thg.incoherent_impl(impl) == jhg.incoherent_impl(impl)
        assert thg.resolve_impl(impl) == jhg.resolve_impl(impl)
    # 'auto' is brick3 in the port (it runs on an accelerator); the JAX
    # package resolves it by backend, 'xla' on the CPU
    assert thg.resolve_impl("auto") == "brick3"
    assert thg.hash_family("auto") == "brick3"
    assert thg.incoherent_impl("auto") == "brick3_plain"
    assert thg.uses_brick3("brick3_plain", torch.bfloat16)
    assert not thg.uses_brick3("brick3", torch.float32)
    with pytest.raises(ValueError):
        thg.encode_dispatch(torch.zeros(6, 1 << 13, 2), torch.zeros(4, 3),
                            T_CFG, torch.bfloat16, "nope")
