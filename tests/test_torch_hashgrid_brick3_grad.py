"""PyTorch port vs the JAX package, the brick3 table gradient (the
backward of the hash encode): the plain twin of the CUDA kernel against
three references, on dense and hashed levels:

  * JAX `hashgrid_table_grad_brick3(exact=True)` (f32 stream, f32 matmul
    operands): the function the port computes;
  * the f32 golden path, `jax.grad` of `hashgrid_encode_brick3_ref`;
  * the JAX default path (exact=False), which quantizes the fractions to
    10 bits and g to bf16 before its sort and runs bf16 matmul operands.

The JAX Pallas backward runs in interpret mode (explicit interpret=True;
through `encode_dispatch` by patching `hashgrid_encode_brick3`, whose
backward is otherwise built with interpret=False, which the CPU backend
refuses)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radnerf_tpu.ops.hashgrid_brick3 as jb3
from radnerf_tpu.models.mngp import MNGPConfig as JCfg
from radnerf_tpu.models.mngp import _encode as j_encode
from radnerf_tpu.ops import hashgrid as jhg
from radnerf_tpu_torch.models.mngp import MNGPConfig, _encode
from radnerf_tpu_torch.ops import hashgrid as thg
from radnerf_tpu_torch.ops import hashgrid_brick3 as tb3

torch.set_num_threads(1)

# res 4..128 over 6 levels: dense AND hashed classes (the JAX suite's CFG)
CFG_KW = dict(n_levels=6, n_features=2, log2_table_size=13,
              base_resolution=4, per_level_scale=2.0)
U32 = 2.0 ** -24                 # unit roundoff of float32


def _cfgs(scale=None, log2_T=None):
    if scale is None:
        return jhg.HashGridConfig(**CFG_KW), thg.HashGridConfig(**CFG_KW)
    return (jhg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T),
            thg.HashGridConfig.for_scene_scale(scale, log2_table_size=log2_T))


def _inputs(tc, n=1500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.125]]
    g = rng.normal(size=(n, 2 * tc.n_levels)).astype(np.float32)
    return x, g


def _term_stats(x, g, tc):
    """Per table entry: the number of terms, sum |w g| and sum |g| of the
    corner products that land on it (float64)."""
    idx, w = tb3._corner_terms(torch.from_numpy(x), tc)
    L, T = tc.n_levels, tc.table_size
    gl = torch.from_numpy(g).double().reshape(-1, L, 2).permute(1, 0, 2)
    gw = (w.double()[..., None] * gl[:, None]).abs()
    ga = gl[:, None].abs().expand_as(gw)
    flat = idx.reshape(-1)

    def acc(v):
        out = torch.zeros((L * T, 2), dtype=torch.float64)
        out.index_add_(0, flat, v.reshape(-1, 2))
        return out.reshape(L, T, 2).numpy()

    return acc(torch.ones_like(gw)), acc(gw), acc(ga)


def _f32_order_tol(count, abs_sum):
    """Two float32 sums of the same n terms in different orders differ by
    at most 2 (n - 1) u sum|terms|; a tiny floor for empty entries."""
    return 2 * np.maximum(count - 1, 1) * U32 * abs_sum + 1e-30


def _port(x, g, tc):
    return tb3.hashgrid_table_grad_brick3(torch.from_numpy(x),
                                          torch.from_numpy(g), tc).numpy()


CASES = [(None, None), (0.5, 12), (1.0, 15)]


@pytest.mark.parametrize("scale,log2_T", CASES)
def test_table_grad_matches_jax_exact_path(scale, log2_T):
    jc, tc = _cfgs(scale, log2_T)
    x, g = _inputs(tc)
    ref = np.asarray(jax.jit(lambda a, b: jb3.hashgrid_table_grad_brick3(
        a, b, jc, interpret=True, exact=True))(x, g))
    got = _port(x, g, tc)
    assert got.shape == (tc.n_levels, tc.table_size, 2)
    count, gw, _ = _term_stats(x, g, tc)
    # the same f32 products, summed in another order (the reference's
    # HIGHEST-precision window matmuls, the port's index_add_)
    assert (np.abs(got - ref) <= _f32_order_tol(count, gw)).all()
    assert (count > 0).sum() > 1000 and (got != 0).sum() > 1000


@pytest.mark.parametrize("scale,log2_T", CASES)
def test_table_grad_matches_golden_jax_grad(scale, log2_T):
    jc, tc = _cfgs(scale, log2_T)
    x, g = _inputs(tc, seed=1)
    table = np.zeros((tc.n_levels, tc.table_size, 2), np.float32)
    ref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        jb3.hashgrid_encode_brick3_ref(t, x, jc, jnp.float32) * g)))(table))
    got = _port(x, g, tc)
    count, gw, _ = _term_stats(x, g, tc)
    # XLA's scatter-add transpose of the golden gathers: the same products
    # in yet another order
    assert (np.abs(got - ref) <= _f32_order_tol(count, gw)).all()


@pytest.mark.parametrize("scale,log2_T", CASES)
def test_table_grad_vs_jax_default_quantized_path(scale, log2_T):
    jc, tc = _cfgs(scale, log2_T)
    x, g = _inputs(tc, seed=2)
    ref = np.asarray(jax.jit(lambda a, b: jb3.hashgrid_table_grad_brick3(
        a, b, jc, interpret=True))(x, g))
    got = _port(x, g, tc)
    count, gw, ga = _term_stats(x, g, tc)
    # per term, the reference's default path perturbs w * g by:
    #  - 10-bit fractions: |df| <= 0.5/1023 per axis, so |dw| <= 1.5/1023
    #    (w is a product of three factors in [0, 1]);
    #  - g rounded to bf16 and the stencil's bf16 operands (two roundings
    #    of the xy and z factors and one of their product): a relative
    #    2^-8 each (bf16 carries 8 significant bits), four in all
    #    (4.1: with their second-order cross terms).
    tol = ga * (1.5 / 1023) * (1 + 2**-6) + gw * 4.1 * 2.0**-8
    assert (np.abs(got - ref) <= tol + _f32_order_tol(count, gw)).all()
    # it is a real difference: the exact gradient is not the quantized one
    assert np.abs(got - ref).max() > 1e-4


def test_table_grad_unsorted_stream_with_repeated_rows():
    """Samples in random order, many sharing a cell (repeated rows, and
    repeated corners within a row): every entry sums all its terms."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    x = base[rng.integers(0, 40, 1200)]
    x = x + rng.uniform(-1e-3, 1e-3, x.shape).astype(np.float32)
    x = np.clip(x, 0, 1).astype(np.float32)
    g = rng.normal(size=(1200, 12)).astype(np.float32)
    got = _port(x, g, tc)
    ref = np.asarray(jax.jit(lambda a, b: jb3.hashgrid_table_grad_brick3(
        a, b, jc, interpret=True, exact=True))(x, g))
    count, gw, _ = _term_stats(x, g, tc)
    assert count.max() >= 20
    assert (np.abs(got - ref) <= _f32_order_tol(count, gw)).all()
    # float64 ground truth of the same terms
    idx, w = tb3._corner_terms(torch.from_numpy(x), tc)
    gl = torch.from_numpy(g).double().reshape(-1, 6, 2).permute(1, 0, 2)
    exact = torch.zeros((6 * tc.table_size, 2), dtype=torch.float64)
    exact.index_add_(0, idx.reshape(-1),
                     (w.double()[..., None] * gl[:, None]).reshape(-1, 2))
    exact = exact.reshape(got.shape).numpy()
    assert (np.abs(got - exact) <= _f32_order_tol(count, gw)).all()


def test_autograd_function_table_grad_equals_plain():
    _, tc = _cfgs()
    x, g = _inputs(tc, seed=4)
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.uniform(-1, 1, (6, tc.table_size, 2)),
                         dtype=torch.float32, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tb3.hashgrid_encode_brick3(table, xt, tc)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tb3.hashgrid_encode_brick3_fwd_impl(
        table.detach(), xt.detach(), tc))
    gt = torch.from_numpy(g).to(torch.bfloat16)
    out.backward(gt)
    assert xt.grad is None                     # no gradient reaches x
    want = tb3._table_grad_plain(xt.detach(), gt.float(), tc)
    assert table.grad.dtype == torch.float32
    assert torch.equal(table.grad, want)
    with pytest.raises(ValueError):
        tb3.hashgrid_table_grad_brick3(xt.detach(), gt, tc)   # bf16 g


def test_encode_grad_through_mngp_matches_jax_encode_dispatch(monkeypatch):
    """The model's `_encode` (brick3, bf16) differentiated on both sides:
    the JAX side through encode_dispatch with its Pallas backward patched
    to interpret mode. The reference's backward is its default
    (quantized) path, so the tolerance is that of the test above."""
    monkeypatch.setattr(jb3, "hashgrid_encode_brick3", functools.partial(
        jb3.hashgrid_encode_brick3, interpret=True))
    kw = dict(scale=0.5, grid_size=16, n_levels=4, log2_T=10, n_experts=2,
              compute_dtype="bfloat16", hash_impl="brick3")
    jcfg, tcfg = JCfg(**kw), MNGPConfig(**kw)
    rng = np.random.default_rng(6)
    table = rng.uniform(-1, 1, (4, 1 << 10, 2)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (800, 3)).astype(np.float32)
    g = rng.normal(size=(800, 8)).astype(np.float32)
    state = {"xyz_min": -0.5 * np.ones(3, np.float32),
             "xyz_max": 0.5 * np.ones(3, np.float32)}
    ref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        j_encode({"hash_table": t}, state, jcfg, x).astype(jnp.float32)
        * g)))(table))
    tt = torch.tensor(table, requires_grad=True)
    feat = _encode({"hash_table": tt},
                   {k: torch.from_numpy(v) for k, v in state.items()},
                   tcfg, torch.from_numpy(x))
    (feat.float() * torch.from_numpy(g)).sum().backward()
    got = tt.grad.numpy()
    xn = np.clip((x + 0.5) / 1.0, 0, 1).astype(np.float32)
    count, gw, ga = _term_stats(xn, g, tcfg.hash)
    tol = ga * (1.5 / 1023) * (1 + 2**-6) + gw * 4.1 * 2.0**-8
    assert (np.abs(got - ref) <= tol + _f32_order_tol(count, gw)).all()
    assert np.abs(got).max() > 1.0
