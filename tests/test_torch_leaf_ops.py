"""PyTorch port vs the JAX package, leaf ops: ray-box intersection, SH
direction encoding, trunc_exp forward, MLPs (f32 and bf16, single and
expert-stacked) and the ray gate. Inputs come from numpy with a seed;
parameters are drawn by the JAX initializers and converted with
radnerf_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import gates as jgates
from radnerf_tpu.models import mlp as jmlp
from radnerf_tpu.ops import intersection as jint
from radnerf_tpu.ops import sh as jsh
from radnerf_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from radnerf_tpu_torch.convert import params_from_jax
from radnerf_tpu_torch.models import gates as tgates
from radnerf_tpu_torch.models import mlp as tmlp
from radnerf_tpu_torch.ops import intersection as tint
from radnerf_tpu_torch.ops import sh as tsh
from radnerf_tpu_torch.ops.trunc_exp import trunc_exp as t_trunc_exp

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8   # relative spacing of bf16 values (8 significant bits)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= rng.uniform(0.1, 2.0, (n, 1)) / np.linalg.norm(o, axis=1,
                                                         keepdims=True)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4, 0] = 0.0          # axis-parallel rays: infinite slab inverse
    return o.astype(np.float32), d.astype(np.float32)


def test_ray_aabb_and_near_far_equal_jax():
    o, d = _rays(500, 0)
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(3, 3)).astype(np.float32) * 0.2
    halves = rng.uniform(0.2, 0.6, (3, 3)).astype(np.float32)
    ref = jax.jit(jint.ray_aabb_intersect)(o, d, centers, halves)
    got = tint.ray_aabb_intersect(*map(torch.from_numpy,
                                       (o, d, centers, halves)))
    # the same IEEE operations in the same order: equal, misses included
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[..., 0] < 0).any() and (got[..., 0] >= 0).any()

    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    r1, r2 = jax.jit(jint.scene_near_far)(o, d, c, h)
    g1, g2 = tint.scene_near_far(*map(torch.from_numpy, (o, d, c, h)))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(r2))
    assert (g1.numpy() == 0.01).any()     # near-plane clamp exercised


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_dir_matches_jax(degree):
    _, d = _rays(400, 2)
    d = d * np.float32(3.0)                # un-normalized input
    ref = jax.jit(lambda v: jsh.sh_encode_dir(v, degree))(d)
    got = tsh.sh_encode_dir(torch.from_numpy(d), degree)
    assert got.shape == (400, degree**2) and got.dtype == torch.float32
    # XLA may fuse c * z2 - k into one fma and computes the norm in its own
    # order: a few float32 ulps of O(1) values
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunc_exp_forward_matches_jax(dtype):
    x = np.random.default_rng(3).uniform(-15, 15, 1000).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    ref = jax.jit(j_trunc_exp)(xj)
    got = t_trunc_exp(torch.tensor(np.asarray(xj.astype(jnp.float32)))
                      .to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    # both exp in float32; XLA's and PyTorch's exp differ by a few ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)


def _mlp_pair(stacked, seed=4):
    key = jax.random.PRNGKey(seed)
    if stacked:
        p = jmlp.init_stacked_mlp(key, 2, 32, 64, 17, 1)
    else:
        p = jmlp.init_mlp(key, 32, 64, 17, 2)
    tp, _ = params_from_jax(_np(p), device="cpu")
    return p, tp


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("out_act", [None, "sigmoid", "exp"])
def test_mlp_f32_matches_jax(stacked, out_act):
    jp, tp = _mlp_pair(stacked)
    x = np.random.default_rng(5).normal(size=(300, 32)).astype(np.float32)
    if stacked:
        ref = jax.vmap(lambda p: jmlp.apply_mlp(p, x, out_act))(jp)
    else:
        ref = jmlp.apply_mlp(jp, x, out_act)
    got = tmlp.apply_mlp(tp, torch.from_numpy(x), out_act)
    assert got.shape == ref.shape
    # float32 matmuls summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_mlp_bf16_matches_jax(stacked):
    jp, tp = _mlp_pair(stacked)
    x = np.random.default_rng(6).normal(size=(300, 32)).astype(np.float32)

    def jf(p):
        return jmlp.apply_mlp(p, x, "sigmoid", jnp.bfloat16)

    ref = np.asarray((jax.vmap(jf)(jp) if stacked else jf(jp))
                     .astype(jnp.float32))
    got = tmlp.apply_mlp(tp, torch.from_numpy(x), "sigmoid",
                         torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # every layer rounds its f32-accumulated output to bf16; a different
    # summation order flips a rounding by one ulp now and then, and later
    # layers carry it: at most a few ulps, most values bit-equal
    assert np.abs(got - ref).max() <= 4 * BF16_ULP * np.abs(ref).max()
    assert (got == ref).mean() > 0.9


def test_init_mlp_layout_and_he_bounds():
    gen = torch.Generator().manual_seed(0)
    tp = tmlp.init_stacked_mlp(gen, 3, 32, 64, 17, 1, device="cpu")
    jp = jmlp.init_stacked_mlp(jax.random.PRNGKey(0), 3, 32, 64, 17, 1)
    for leaf in ("w", "b"):
        assert [tuple(a.shape) for a in tp[leaf]] == [
            a.shape for a in jp[leaf]]
    for w in tp["w"]:
        bound = np.sqrt(6.0 / w.shape[-2])
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.9 * bound     # uniform, not normal
    assert all(float(b.abs().max()) == 0.0 for b in tp["b"])
    again = tmlp.init_stacked_mlp(torch.Generator().manual_seed(0), 3, 32,
                                  64, 17, 1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp["w"], again["w"]))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_ray_gate_matches_jax(cdtype):
    jg = jgates.init_ray_gate(jax.random.PRNGKey(8), 3)
    _, tg = params_from_jax({}, _np(jg), device="cpu")
    o, d = _rays(256, 9)
    x = np.concatenate([o, d], axis=1)
    gate, imp, top = jax.jit(lambda p, v: jgates.apply_ray_gate(
        p, v, getattr(jnp, cdtype)))(jg, x)
    tgate, timp, ttop = tgates.apply_ray_gate(
        tg, torch.from_numpy(x), getattr(torch, cdtype))
    assert top is None and ttop is None and tgate.dtype == torch.float32
    # bf16: the logits carry the bf16 MLP's few-ulp differences (see
    # test_mlp_bf16_matches_jax); softmax of O(1) logits moves < 1e-2
    tol = 1e-5 if cdtype == "float32" else 1e-2
    np.testing.assert_allclose(tgate.numpy(), np.asarray(gate), atol=tol)
    np.testing.assert_allclose(timp.numpy(), np.asarray(imp),
                               atol=256 * tol)
    torch.testing.assert_close(tgate.sum(1), torch.ones(256))
