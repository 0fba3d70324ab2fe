"""PyTorch port vs the JAX package, the dense sample layout at a small
size (scale 0.5, G=16 or 32, L=4, T=2^10, bf16, brick3; 16-128 rays):
the dense march (`_compact_keep`, `march_rays_train`,
`march_rays_test_block`, bit-equal), the row scan and the compositors
(`composite_weights`, `composite_train` with its gradients,
`composite_test_block`), `distortion_loss` with its gradients, the single
field's dense `render_train` (outputs and every gradient leaf),
`render_test` and `render_test_compacted` on both test layouts, the MoE's
dense `ml_render_train` and `ml_render_test` (shared encoder and
unshared), one dense MoE step's loss and every leaf, and the switch and
block baselines' dense train and test renders.

The JAX Pallas backwards run in interpret mode (test_torch_ml_train's
`patched`); the shapes reach the reference's Pallas occupancy kernel.
Each test states its tolerance.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.ops import compositing as jc
from radnerf_tpu.ops import distortion as jd
from radnerf_tpu.ops import marching as jm
from radnerf_tpu.ops.intersection import scene_near_far
from radnerf_tpu.parallel.step import (
    microbatched_value_and_grad as j_microbatched_vg,
)
from radnerf_tpu.render.ml_render import ml_render_test as j_ml_render_test
from radnerf_tpu.render.ml_render import ml_render_train as j_ml_render_train
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu.render.render import render_test as j_render_test
from radnerf_tpu.render.render import (
    render_test_compacted as j_render_test_compacted,
)
from radnerf_tpu.render.render import render_train as j_render_train
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.losses import nerf_loss, total_loss
from radnerf_tpu_torch.models.mngp import MNGPConfig
from radnerf_tpu_torch.ops import compositing as tc
from radnerf_tpu_torch.ops import distortion as td
from radnerf_tpu_torch.ops import marching as tm
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves,
)
from radnerf_tpu_torch.render.ml_render import ml_render_test, ml_render_train
from radnerf_tpu_torch.render.render import (
    RenderConfig, render_test, render_test_compacted, render_train,
)
from radnerf_tpu_torch.train import trainer as tt

from .test_torch_expert_renders import _models
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    CFG_KW, GRAD_RTOL, GRAD_RTOL_DEFAULT, LOSS_W, _batch, _j_loss, _setup,
    _store, _t_batch, _t_data, patched,
)
from .test_torch_single_field import _field, _rays
from .test_torch_train_ops import _union_setup

torch.set_num_threads(1)

DENSE_KW = dict(samples_per_ray=32, layout="dense")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_far(o, d):
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    return (np.asarray(a) for a in jax.jit(scene_near_far)(o, d, c, h))


def _check_leaves(jg, grads, n_leaves):
    """Each gradient leaf within test_torch_ml_train's GRAD_RTOL of its
    largest entry (the reference's table gradient quantized, the
    port's exact; the bf16 MLPs one rounding apart now and then)."""
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == n_leaves
    for (path, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
            GRAD_RTOL_DEFAULT
        scale = np.abs(r).max()
        assert scale > 0 and g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, (
            name, np.abs(g.numpy() - r).max() / scale)


# ----------------------------------------------------------------- march
@pytest.mark.parametrize("S", [8, 96])
def test_compact_keep_is_bit_equal(S):
    """Rows with no kept candidate, fewer than S and more than S."""
    rng = np.random.default_rng(S)
    N, K = 48, 256
    keep = rng.random((N, K)) < rng.uniform(0, 0.6, (N, 1))
    keep[:3] = False
    t = np.sort(rng.uniform(0, 2, (N, K)), axis=1).astype(np.float32)
    dt = rng.uniform(1e-3, 1e-2, (N, K)).astype(np.float32)
    ref = jax.jit(lambda t, dt, k: jm._compact_keep(t, dt, k, S))(t, dt, keep)
    got = tm._compact_keep(_t(t), _t(dt), _t(keep), S)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    n = got[3].numpy()
    assert (n == 0).any() and (n == S).any() and ((n > 0) & (n < S)).any()


@pytest.mark.parametrize("kw", [dict(samples_per_ray=32),
                                dict(samples_per_ray=192),
                                dict(samples_per_ray=32,
                                     exp_step_factor=1 / 256)])
@pytest.mark.parametrize("jitter", [True, False])
def test_march_rays_train_is_bit_equal(kw, jitter):
    """N=64 rays, 1024 candidates each (the reference's Pallas occupancy
    kernel): valid and n_samples equal; ts and deltas equal on the linear
    lattice, and on the exponential one within 1e-5 relative (its
    geometric phase goes through exp, which XLA and PyTorch round an ulp
    or two apart: test_torch_marching's sample_lattice)."""
    jcfg = jm.MarchConfig(scale=0.5, grid_size=32, **kw)
    tcfg = tm.MarchConfig(scale=0.5, grid_size=32, **kw)
    o, d, occ, noise = _union_setup()
    t1, t2 = _near_far(o, d)
    nz = noise if jitter else None
    ref = jax.jit(lambda o, d, t1, t2, occ, nz: jm.march_rays_train(
        o, d, t1, t2, occ, jcfg, nz))(o, d, t1, t2, occ[0], nz)
    got = tm.march_rays_train(*map(_t, (o, d, t1, t2, occ[0])), tcfg,
                              None if nz is None else _t(nz))
    for k in ("ts", "deltas", "valid", "n_samples"):
        if k in ("ts", "deltas") and "exp_step_factor" in kw:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
    n = got["n_samples"].numpy()
    assert n.sum() > 100 and (n == 0).any()
    assert not got["ts"].requires_grad


@pytest.mark.parametrize("S,k_block", [(32, 512), (8, 128)])
def test_march_rays_test_block_is_bit_equal(S, k_block):
    """Three resumed blocks: the cursor rule, the S-th kept candidate and
    the clamp to t2, with rays that miss the box."""
    jcfg = jm.MarchConfig(scale=0.5, grid_size=32)
    tcfg = tm.MarchConfig(scale=0.5, grid_size=32)
    o, d, occ, _ = _union_setup()
    d[:4] = -d[:4]                                # pointing away: miss
    t1, t2 = _near_far(o, d)
    assert (t1 < 0).any()
    jf = jax.jit(lambda cur: jm.march_rays_test_block(
        o, d, cur, t2, occ[0], jcfg, n_samples=S, k_block=k_block))
    cur_j, cur_t = t1, _t(t1)
    for _ in range(3):
        ref = jf(cur_j)
        got = tm.march_rays_test_block(
            *map(_t, (o, d)), cur_t, _t(t2), _t(occ[0]), tcfg, n_samples=S,
            k_block=k_block)
        for k in ("ts", "deltas", "valid", "n_eff", "new_cursor"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
        cur_j, cur_t = ref["new_cursor"], got["new_cursor"]
    assert int(got["n_eff"].sum()) > 0


# -------------------------------------------------------- compositing
def _dense_block(N=48, S=40, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, N)
    n[:2] = 0
    valid = np.arange(S)[None] < n[:, None]
    sig = np.exp(rng.normal(2.0, 2.5, (N, S))).astype(np.float32)
    deltas = np.where(valid, rng.uniform(1e-3, 2e-2, (N, S)), 0).astype(
        np.float32)
    ts = np.where(valid, np.cumsum(deltas, 1) + 0.3, 0).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return sig, rgb, deltas, ts, valid


@pytest.mark.parametrize("S", [16, 40, 200])
def test_cumsum_is_the_reference_order(S):
    """The row scan equals jnp.cumsum on XLA's CPU backend bit for bit,
    forward and backward (rows of one block, a ragged last block, and
    two levels of blocks)."""
    rng = np.random.default_rng(S)
    v = np.exp(rng.normal(0, 2, (3, 20, S))).astype(np.float32)
    w = rng.normal(size=(3, 20, S)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(v))
    ref_g = np.asarray(jax.jit(jax.grad(
        lambda a: (jnp.cumsum(a, axis=-1) * w).sum()))(v))
    x = _t(v).requires_grad_()
    got = tc.cumsum(x)
    (got * _t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    np.testing.assert_array_equal(x.grad.numpy(), ref_g)
    # and torch's own cumsum does not sum in that order
    assert not np.array_equal(torch.cumsum(_t(v), -1).numpy(), ref)


# alpha = 1 - exp(-sd) cancels: an ulp of exp(-sd) near 1, where XLA's
# and PyTorch's exp may round apart, is 2^-24 of alpha absolute; the row
# scan is the reference's bit for bit. So the weights are held at 4e-6
# relative or 2^-22 absolute (two ulps of 1 through alpha, times T <= 1)
W_RTOL, W_ATOL = 4e-6, 2.0**-22


def test_composite_weights_with_carry_in_match_jax():
    """Weights and the carry-out transmittance, with rays that die inside
    the row (W_RTOL, W_ATOL)."""
    sig, _, deltas, _, valid = _dense_block()
    prev = np.random.default_rng(1).uniform(2e-4, 1, 48).astype(np.float32)
    for p in (None, prev):
        ref = jax.jit(lambda s, d, v, p: jc.composite_weights(
            s, d, v, 1e-4, p))(sig, deltas, valid, p)
        got = tc.composite_weights(_t(sig), _t(deltas), _t(valid), 1e-4,
                                   None if p is None else _t(p))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=W_RTOL, atol=W_ATOL)
    w, t_after = got
    assert ((w.numpy() == 0) & valid).any()       # died inside the row
    assert (t_after.numpy() < 1).all()


def test_composite_train_forward_and_vjp_match_jax():
    """Outputs (sums of at most S weights: S x the weights' W_RTOL and
    W_ATOL) and the gradients of a random linear function of them in
    sigmas and rgbs (1e-5 of each leaf's largest entry: the backward's
    sums in other orders)."""
    sig, rgb, deltas, ts, valid = _dense_block(seed=2)
    S = sig.shape[1]
    rng = np.random.default_rng(3)
    co = rng.normal(size=48).astype(np.float32)
    cd = rng.normal(size=48).astype(np.float32)
    cr = rng.normal(size=(48, 3)).astype(np.float32)

    def f(out, c):
        return ((out["opacity"] * c[0]).sum() + (out["depth"] * c[1]).sum()
                + (out["rgb"] * c[2]).sum())

    def jf(s, r):
        return f(jc.composite_train(s, r, deltas, ts, valid), (co, cd, cr))

    ref = jax.jit(lambda s, r: jc.composite_train(s, r, deltas, ts, valid))(
        sig, rgb)
    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(sig, rgb)
    s, r = _t(sig).requires_grad_(), _t(rgb).requires_grad_()
    out = tc.composite_train(s, r, _t(deltas), _t(ts), _t(valid))
    grads = torch.autograd.grad(f(out, tuple(map(_t, (co, cd, cr)))),
                                (s, r))
    for k in ("opacity", "depth", "rgb", "ws"):
        n = 1 if k == "ws" else S
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=n * W_RTOL,
                                   atol=n * W_ATOL, err_msg=k)
    np.testing.assert_array_equal(out["vr_samples"].numpy(),
                                  np.asarray(ref["vr_samples"]))
    for g, r_ in zip(grads, jg):
        r_ = np.asarray(r_)
        assert np.abs(g.numpy() - r_).max() <= 1e-5 * np.abs(r_).max()


def test_composite_test_block_matches_jax():
    """Two resumed blocks from a carry with dead rays: the weights at
    W_RTOL / W_ATOL, the sums over a block's S at S times that."""
    sig, rgb, deltas, ts, valid = _dense_block(seed=4)
    S = sig.shape[1]
    rng = np.random.default_rng(5)
    acc = {"opacity": rng.uniform(0, 0.5, 48).astype(np.float32),
           "depth": rng.uniform(0, 1, 48).astype(np.float32),
           "rgb": rng.uniform(0, 0.5, (48, 3)).astype(np.float32),
           "transmittance": rng.uniform(2e-4, 1, 48).astype(np.float32),
           "alive": rng.random(48) < 0.85}
    ref, got = acc, {k: _t(v) for k, v in acc.items()}
    for it in range(2):
        ref = jax.jit(lambda a: jc.composite_test_block(
            sig, rgb, deltas, ts, valid, a))(ref)
        got = tc.composite_test_block(_t(sig), _t(rgb), _t(deltas), _t(ts),
                                      _t(valid), got)
        for k in ref:
            n = (it + 1) * (1 if k == "transmittance" else S)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=n * W_RTOL, atol=n * W_ATOL,
                                       err_msg=k)
    assert not got["alive"].all() and got["alive"].any()


def test_distortion_loss_and_its_gradient_match_jax():
    """Per-ray loss of (2, N, S) per-expert weights, the same weights on
    both sides. Each sample's 2 (wts_incl ws_excl - ws_incl wts_excl)
    cancels, and XLA contracts it into a fused multiply-add: the loss
    within 4 f32 ulps of the sum over the row of the two products'
    magnitudes (and of w^2 delta / 3); its gradient in ws within 1e-5 of
    the largest entry."""
    sig, _, deltas, ts, valid = _dense_block(seed=6)
    ws = np.asarray(jc.composite_weights(sig, deltas, valid)[0])
    ws2 = np.stack([ws, ws[::-1] * 0.5])
    d2, t2, v2 = (np.stack([a, a[::-1]]) for a in (deltas, ts, valid))
    ref = np.asarray(jax.jit(jax.vmap(jd.distortion_loss))(ws2, d2, t2, v2))
    jg = jax.jit(jax.grad(lambda w: jax.vmap(jd.distortion_loss)(
        w, d2, t2, v2).sum()))(ws2)
    w = _t(ws2).requires_grad_()
    got = td.distortion_loss(w, _t(d2), _t(t2), _t(v2))
    (g,) = torch.autograd.grad(got.sum(), w)
    w64 = np.where(v2, ws2, 0).astype(np.float64)
    wt = w64 * t2
    wi, wti = np.cumsum(w64, -1), np.cumsum(wt, -1)
    mag = (2 * (np.abs(wti * (wi - w64)) + np.abs(wi * (wti - wt)))
           + w64 * w64 * d2 / 3).sum(-1)
    assert (np.abs(got.detach().numpy() - ref) <= 4 * 2.0**-24 * mag).all()
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    assert float(got.detach().sum()) > 0


# --------------------------------------------------------- single field
def _j_dense_loss(jcfg, state, rcfg, o, d, noise, target, lw):
    def loss(p):
        out = j_render_train(p, state, jcfg, o, d, jax.random.PRNGKey(3),
                             rcfg, noise=noise)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **lw)), out
    return loss


def test_render_train_dense_outputs_and_every_gradient_leaf_match_jax(
        patched):
    """The single field on the dense layout, with the distortion loss on
    (its dense branch): the march exact; rgb 1e-2, opacity, depth and ws
    1e-3 (bf16 MLPs one rounding apart now and then); the loss 1e-3
    relative; each leaf within GRAD_RTOL."""
    (jcfg, params, state), (tcfg, tp, ts) = _field()
    o, d = _rays(64)
    rng = np.random.default_rng(2)
    noise = rng.random(64).astype(np.float32)
    target = rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32)
    lw = dict(lambda_distortion=1e-2)
    rj, rt = JRender(**DENSE_KW), RenderConfig(**DENSE_KW)
    (jl, ref), jg = jax.jit(jax.value_and_grad(
        _j_dense_loss(jcfg, state, rj, o, d, noise, target, lw),
        has_aux=True))(params)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    out = render_train(tp, ts, tcfg, _t(o), _t(d), rt, noise=_t(noise))
    ld = nerf_loss(out, {"rgb": _t(target)}, **lw)
    loss = total_loss(ld)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for k in ("ts", "deltas", "valid", "n_samples", "rm_samples",
              "total_samples"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["ts"].shape == (64, 32) and "ray_id" not in out
    assert "budget_util" not in out and "distortion" in ld
    assert int(out["rm_samples"]) > 500
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    _check_leaves(jg, grads, 1 + 2 * 2 + 2 * 3)


def test_render_test_dense_matches_jax():
    """The dense test loop: the march exact (the same sample count), rgb
    1e-2, opacity and depth 1e-3 (a table of structure, as the flat
    render's test)."""
    (jcfg, params, state), (tcfg, tp, ts) = _field(structured=True)
    o, d = _rays(64, seed=3)
    rkw = dict(test_layout="dense", test_block_samples=16)
    ref = jax.jit(lambda p, o, d: j_render_test(p, state, jcfg, o, d,
                                                JRender(**rkw)))(params, o, d)
    got = render_test(tp, ts, tcfg, _t(o), _t(d), RenderConfig(**rkw))
    assert int(got["total_samples"]) == int(ref["total_samples"])
    assert got["iterations"] > 1
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_render_test_compacted_matches_jax_and_render_test(layout):
    """render_test_compacted on both test layouts against the reference's:
    the same samples; rgb 1e-2, opacity and depth 1e-3 as above. Dense:
    equal to the port's own render_test within 1e-6 (the per-ray math is
    the same; only the lanes move). Flat: the same sample total as
    render_test, but not its values: the static budget spreads over
    fewer rays, so a ray composites in other pieces (the reference's
    compacted and plain renders differ by ~1e-3 here too)."""
    (jcfg, params, state), (tcfg, tp, ts) = _field(structured=True)
    o, d = _rays(160, seed=5)
    rkw = dict(test_layout=layout, test_block_samples=16, test_k_block=128,
               test_budget_per_ray=8)
    ref = j_render_test_compacted(params, state, jcfg, jnp.asarray(o),
                                  jnp.asarray(d), JRender(**rkw),
                                  phase_iters=2)
    got = render_test_compacted(tp, ts, tcfg, _t(o), _t(d),
                                RenderConfig(**rkw), phase_iters=2)
    plain = render_test(tp, ts, tcfg, _t(o), _t(d), RenderConfig(**rkw))
    assert int(got["total_samples"]) == int(ref["total_samples"]) == int(
        plain["total_samples"])
    assert got["iterations"] > plain["iterations"] // 2
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
        if layout == "dense":
            np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


# ------------------------------------------------------------------ MoE
PATHS = {
    "shared": dict(CFG_KW),
    "unshared": dict(CFG_KW, shared_encoder=False),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_ml_render_train_dense_and_every_gradient_leaf_match_jax(patched,
                                                                  path):
    """Each expert marches its own grid (union sampling applies to the
    flat layout only), expert k's jitter mod(noise + k/K, 1): the marches
    exact; rgb 1e-2, opacity, depth and ws 1e-3, the gate 1e-5; the loss
    with the dense distortion term 1e-3 relative; every leaf within
    GRAD_RTOL."""
    (jcfg, params, gate, state), (tcfg, tp, tg, ts) = _models(PATHS[path])
    rj, rt = JRender(**DENSE_KW), RenderConfig(**DENSE_KW)
    o, d = _rays(64)
    rng = np.random.default_rng(2)
    noise = rng.random(64).astype(np.float32)
    target = rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32)
    lw = dict(LOSS_W, lambda_distortion=1e-2)

    def j_loss(bundle):
        out = j_ml_render_train(bundle["model"], state, jcfg, bundle["gate"],
                                o, d, d, jax.random.PRNGKey(3), rj,
                                noise=noise)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **lw)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        {"model": params, "gate": gate})
    bundle = {"model": tp, "gate": tg}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    out = ml_render_train(tp, ts, tcfg, tg, _t(o), _t(d), _t(d), rt,
                          noise=_t(noise))
    ld = nerf_loss(out, {"rgb": _t(target)}, **lw)
    loss = total_loss(ld)
    grads = torch.autograd.grad(loss, tree_leaves(bundle))
    for k in ("ts", "deltas", "valid", "rm_samples", "total_samples",
              "budget_util"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["ts"].shape == (2, 64, 32) and "ray_id" not in out
    assert not torch.equal(out["ts"][0], out["ts"][1])
    assert float(out["budget_util"]) == 0.0 and "distortion" in ld
    for k, atol in (("rgb", 1e-2), ("independent_rgbs", 1e-2),
                    ("opacity", 1e-3), ("depth", 1e-3), ("ws", 1e-3),
                    ("gating_code", 1e-5)):
        got = out[k].detach().numpy()
        assert got.shape == np.shape(ref[k]), k
        np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    _check_leaves(jg, grads, 1 + 2 * 2 + 2 * 3 + 2 * 5)


@pytest.mark.parametrize("path", list(PATHS))
def test_ml_render_test_dense_matches_jax(path):
    """Each expert's dense render_test (the reference vmaps them in
    lockstep, each lane stopping on its own condition): the same samples;
    rgb 1e-2, opacity and depth 1e-4, the gate 1e-5, as the flat
    per-expert test render."""
    (jcfg, params, gate, state), (tcfg, tp, tg, ts) = _models(PATHS[path])
    o, d = _rays(64, seed=4)
    rkw = dict(test_layout="dense", test_block_samples=32)
    ref = jax.jit(lambda p, g, o, d: j_ml_render_test(
        p, state, jcfg, g, o, d, d, JRender(**rkw)))(params, gate, o, d)
    got = ml_render_test(tp, ts, tcfg, tg, _t(o), _t(d), _t(d),
                         RenderConfig(**rkw))
    assert int(got["total_samples"]) == int(ref["total_samples"])
    for k, atol in (("rgb", 1e-2), ("independent_rgbs", 1e-2),
                    ("opacity", 1e-4), ("depth", 1e-4),
                    ("gating_code", 1e-5), ("gating_importance", 1e-3)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3
    assert float(got["depth"][:, 1].sum()) < float(got["depth"][:, 0].sum())


def test_dense_moe_step_loss_and_every_leaf_match_jax(patched):
    """One microbatched MoE step on the dense layout (2 slices of 64 rays,
    samples_per_ray 32), through the trainer's loss against trainer.py's
    loss_fn with the jitter an input: the sample count exact, the loss
    and PSNR 1e-3 relative, budget_util 0 on both sides, every leaf
    within GRAD_RTOL (test_torch_ml_train's flat step)."""
    jcfg, jbundle, jstate = _setup()
    rkw = dict(DENSE_KW, union_budget_factor=1.0)
    data = _store()
    batch = _batch(0)
    (jl, jaux), jg = jax.jit(j_microbatched_vg(
        _j_loss(jcfg, JRender(**rkw), jstate, data), 2))(
        jbundle, batch, jax.random.PRNGKey(5))
    tcfg = MNGPConfig(**CFG_KW)
    tp, tg = params_from_jax(_np(jbundle["model"]), _np(jbundle["gate"]),
                             device="cpu")
    bundle = {"model": tp, "gate": tg}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    ts = state_from_jax(_np(jstate), device="cpu")
    tdata = _t_data(data)
    tdata["mean_dir"] = tdata["directions"].mean(0)
    train_cfg = tt.TrainConfig(batch_size=128, microbatch=2,
                               samples_per_ray=32, layout="dense")
    rcfg = tt.render_config(tcfg, train_cfg)
    assert rcfg == RenderConfig(**rkw)
    vg = microbatched_value_and_grad(
        lambda b, bt: tt.loss_fn(b, ts, bt, tdata, tcfg, rcfg, train_cfg), 2)
    (loss, aux), grads = vg(bundle, _t_batch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    assert float(aux["rm_samples"]) == float(jaux["rm_samples"]) > 100
    assert float(aux["budget_util"]) == float(jaux["budget_util"]) == 0.0
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                               rtol=1e-3)
    _check_leaves(jg, tree_leaves(grads), 1 + 2 * 2 + 2 * 3 + 2 * 5)


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("kind", ["switch", "block"])
def test_baseline_dense_render_train_and_every_leaf_match_jax(patched,
                                                              kind):
    """Switch: the point gate routes every one of the N x S slots, pad
    slots included (their points at the ray's origin, clamped into the
    box), so the gate noise has N x S rows; its code equal on every slot,
    its load 1e-3 of its largest entry. Block: each ray's gate repeated
    over its S slots (the reference's dense_S branch), under a gate of
    unequal rows. Both: the march exact; rgb 1e-2, opacity, depth and ws
    1e-3; the loss 1e-3 relative; every leaf within test_torch_baselines'
    bf16 tolerances (switch) or GRAD_RTOL (block)."""
    import radnerf_tpu.render.block_render as jbr
    import radnerf_tpu.render.switch_render as jsr
    import radnerf_tpu_torch.render.block_render as tbr
    import radnerf_tpu_torch.render.switch_render as tsr

    from .test_torch_baselines import (
        GRAD_RTOL_DEFAULT as B_DEFAULT, LOSS_W as B_LOSS_W, SWITCH_BF16_RTOL,
        SWITCH_LOSS_W, _gate_codes, _switch_draws,
    )
    from .test_torch_baselines import _models as b_models

    (jcfg, params, state), (tcfg, tp, ts) = b_models(kind)
    N, S = 64, 32
    o, d = _rays(N)
    rng = np.random.default_rng(2)
    target = rng.uniform(0.2, 0.8, (N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rj, rt = JRender(**DENSE_KW), RenderConfig(**DENSE_KW)
    noise, gate_noise = _switch_draws(key, N, S, 2)
    if kind == "block":       # render_train's own draw from the key
        noise = np.array(jax.random.uniform(jax.random.split(key)[0], (N,)))
    gate = _gate_codes(N)
    gate[::2] *= 0.75
    lw = SWITCH_LOSS_W if kind == "switch" else B_LOSS_W

    def j_loss(p):
        if kind == "switch":
            out = jsr.switch_render_train(p, state, jcfg, o, d, key, rj)
            out["gating_importance"] = out["gating_importance"].astype(
                jnp.float32)
        else:
            out = jbr.block_render_train(p, state, jcfg, o, d, gate, key, rj)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **lw)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    if kind == "switch":
        out = tsr.switch_render_train(tp, ts, tcfg, _t(o), _t(d), rt,
                                      noise=_t(noise),
                                      gate_noise=_t(gate_noise))
    else:
        out = tbr.block_render_train(tp, ts, tcfg, _t(o), _t(d), _t(gate),
                                     rt, noise=_t(noise))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}, **lw))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for k in ("ts", "deltas", "valid", "rm_samples"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["ts"].shape == (N, S) and int(out["rm_samples"]) > 300
    if kind == "switch":
        assert out["gating_code"].shape == (N * S, 2)
        np.testing.assert_array_equal(out["gating_code"].detach().numpy(),
                                      np.asarray(ref["gating_code"]))
        ri = np.asarray(ref["gating_importance"], np.float32)
        assert np.abs(out["gating_importance"].detach().numpy() - ri).max() \
            <= 1e-3 * np.abs(ri).max()
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == (
        1 + 12 + 4 + 6 + 6 if kind == "switch" else 1 + 4 + 6)
    for (path, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        if kind == "switch":
            tol = next((v for k, v in SWITCH_BF16_RTOL.items() if k in name),
                       B_DEFAULT)
        else:
            tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
                GRAD_RTOL_DEFAULT
        scale = np.abs(r).max()
        assert scale > 0 and tuple(g.shape) == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, name


@pytest.mark.parametrize("kind", ["switch", "block"])
def test_baseline_dense_render_test_matches_jax(kind):
    """On the dense test layout the reference's block render works (its
    closure repeats the gate test_block_samples times), so the port's is
    held against it directly; the switch routes as the JAX gate does
    (test_torch_baselines' _jax_routing, near ties only, at most 1% of
    the slots). The same samples; rgb 1e-2, opacity and depth 5e-3 (the
    switch, as its flat test render) or 1e-3 (block)."""
    import radnerf_tpu.render.block_render as jbr
    import radnerf_tpu.render.switch_render as jsr
    import radnerf_tpu_torch.render.block_render as tbr
    import radnerf_tpu_torch.render.switch_render as tsr

    from .test_torch_baselines import _gate_codes, _jax_routing
    from .test_torch_baselines import _models as b_models

    (jcfg, params, state), (tcfg, tp, ts) = b_models(kind, structured=True)
    o, d = _rays(64, seed=3)
    rkw = dict(test_layout="dense", test_block_samples=32)
    gate = _gate_codes(64)
    gate[::3] *= 0.5
    if kind == "switch":
        ref = jax.jit(lambda p, o, d: jsr.switch_render_test(
            p, state, jcfg, o, d, JRender(**rkw)))(params, o, d)
        with _jax_routing(params) as calls:
            got = tsr.switch_render_test(tp, ts, tcfg, _t(o), _t(d),
                                         RenderConfig(**rkw))
        assert len(calls) == got["iterations"] > 1
        assert sum(f for _, f in calls) <= 1e-2 * sum(n for n, _ in calls)
        tol = 5e-3
    else:
        ref = jax.jit(lambda p, o, d: jbr.block_render_test(
            p, state, jcfg, o, d, gate, JRender(**rkw)))(params, o, d)
        got = tbr.block_render_test(tp, ts, tcfg, _t(o), _t(d), _t(gate),
                                    RenderConfig(**rkw))
        np.testing.assert_array_equal(got["gating_code"].numpy(), gate)
        tol = 1e-3
    assert int(got["total_samples"]) == int(ref["total_samples"])
    for k, atol in (("rgb", 1e-2), ("opacity", tol), ("depth", tol)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


# ---------------------------------------------------------- entry points
ENTRY = ("Synthetic_NeRF", "TestSphere")
SMALL = dict(grid_size=32, n_levels=4)


def _entry_args(root, exp, *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", ENTRY[0], "--scene_name", ENTRY[1],
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "128", "--num_epochs", "1",
            "--steps_per_epoch", "3", "--samples_per_ray", "48",
            "--val_chunk", "1024", "--no_save_test", "--hash_impl",
            "brick3", "--layout", "dense", *extra]


@pytest.fixture(scope="module")
def entry_dir(tmp_path_factory):
    """The NSVF fixture scene, a working directory, and the port's configs
    cut to 32^3 grids and 4 levels (brick3 pinned for the baselines)."""
    from radnerf_tpu_torch.train import other_trainer as tot

    from .fixtures import make_nsvf_dataset

    root = make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((tt, "MNGPConfig"), (tt, "NGPConfig"),
                          (tot, "SwitchNGPConfig"),
                          (tot, "BlockNGPConfig")):
            kw = dict(SMALL, hash_impl="brick3") if mod is tot else SMALL
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    **kw))
        os.chdir(work)
        try:
            yield root
        finally:
            os.chdir(cwd)


def _trained(system, steps):
    assert [s for s, _, _ in steps] == [0, 1, 2]
    assert all(np.isfinite(v) and u == 0.0 for _, v, u in steps)
    assert system.trainer.rcfg.layout == "dense"
    assert system.trainer.rcfg.budget_per_ray == 64   # no budget to adapt
    with open(os.path.join("logs", *ENTRY, system.h.exp_name,
                           "metrics.jsonl")) as f:
        psnr = [json.loads(line)["value"] for line in f
                if '"test/psnr"' in line]
    assert len(psnr) == 1 and np.isfinite(psnr[0])


def _on_step(seen):
    return lambda s, loss, aux: seen.append(
        (s, float(loss), float(aux["budget_util"])))


def test_train_ml_main_trains_on_the_dense_layout(entry_dir):
    """python -m radnerf_tpu_torch.train_ml --layout dense on the CPU: 3
    steps (finite losses, budget_util 0), a validation and a
    checkpoint."""
    from radnerf_tpu_torch import train_ml

    seen = []
    system = train_ml.main(_entry_args(entry_dir, "ml_dense"), device="cpu",
                           on_step=_on_step(seen))
    _trained(system, seen)
    assert system.moe and system.trainer.rcfg.test_layout == "flat"
    system.close()


def test_train_py_main_trains_on_the_dense_layout_and_validates_compacted(
        entry_dir):
    """train.py's single field with --layout dense: 3 steps and a
    validation; then, on the dense test layout, validation renders with
    render_test_compacted (the reference's val_compaction branch),
    within 1e-6 of the plain dense render_test of the same view."""
    import dataclasses

    from radnerf_tpu_torch.render import render as trender
    from radnerf_tpu_torch.train.__main__ import main as train_main

    seen = []
    system = train_main(_entry_args(entry_dir, "single_dense"),
                        device="cpu", on_step=_on_step(seen))
    _trained(system, seen)
    assert not system.moe
    tr = system.trainer
    tr.rcfg = dataclasses.replace(tr.rcfg, test_layout="dense")
    ds = system.test_dataset
    pose, dirs = torch.from_numpy(ds.poses[0]), torch.from_numpy(
        ds.directions)
    calls = []
    orig = trender.render_test_compacted

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tt.render_test_compacted = counted
    try:
        got = system.render_view(pose, dirs)
    finally:
        tt.render_test_compacted = orig
    assert len(calls) == -(-dirs.shape[0] // system.h.val_chunk)
    system.h.val_compaction = False
    plain = system.render_view(pose, dirs)
    assert got["total_samples"] == plain["total_samples"] > 0
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    system.close()


@pytest.mark.parametrize("kind", ["switch", "block"])
def test_train_other_main_trains_on_the_dense_layout(entry_dir, kind):
    """train_other.py's switch (the point gate on every N x S slot) and
    block (the gate repeated over each ray's slots) with --layout dense:
    3 steps, a validation, a checkpoint."""
    from radnerf_tpu_torch import train_other

    seen = []
    system = train_other.main(
        _entry_args(entry_dir, f"{kind}_dense", "--model_type", kind,
                    "--model_zoo_size", "2", "--gate_type", "point"),
        device="cpu", on_step=_on_step(seen))
    _trained(system, seen)
    assert os.path.exists(os.path.join("ckpts", *ENTRY, f"{kind}_dense",
                                       "epoch=0.ckpt"))
    system.close()
