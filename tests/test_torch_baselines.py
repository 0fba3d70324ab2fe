"""PyTorch port vs the JAX package, train_other.py's three baselines at a
small size (scale 0.5, G=16 or 32, L=4, T=2^10-2^11, bf16, hash_impl
pinned on both sides, the flat layout): the Switch-NeRF point gate; the
switch and block fields; their training renders with every gradient
leaf, the JAX draws handed to the port; their test renders (block's
held against the reference's own definition, since the JAX
block_render_test fails on the flat test layout); the NGP-zoo
moe_render_train; k-means anchors and the spatial gate; the grid update
with each model's densities; then OtherNeRFSystem on the NSVF fixture
scene: one Adam step against the JAX system's train_step, checkpoints
both ways, and train_other.main on the CPU for all three model types,
past the JAX system's step-15 fault.

The JAX Pallas backwards run in interpret mode (test_torch_ml_train's
`patched`). Each test states its tolerance.
"""

import contextlib
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.models import block as jblock
from radnerf_tpu.models import gates as jgates
from radnerf_tpu.models import mngp as jmngp
from radnerf_tpu.models import ngp as jngp
from radnerf_tpu.models import switch as jswitch
from radnerf_tpu.render import block_render as jbr
from radnerf_tpu.render import switch_render as jsr
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu.render.render import render_test as j_render_test
from radnerf_tpu.train import other_trainer as jot
from radnerf_tpu.utils import ckpt as jck
from radnerf_tpu_torch import train_other
from radnerf_tpu_torch.convert import (
    params_from_jax, params_to_jax, state_from_jax,
)
from radnerf_tpu_torch.losses import nerf_loss, total_loss
from radnerf_tpu_torch.models import block as tblock
from radnerf_tpu_torch.models import gates as tgates
from radnerf_tpu_torch.models import ngp as tngp
from radnerf_tpu_torch.models import switch as tswitch
from radnerf_tpu_torch.models.zoo import NGPZooConfig
from radnerf_tpu_torch.opt import get_opts
from radnerf_tpu_torch.parallel.step import (
    tree_leaves, tree_paths,
)
from radnerf_tpu_torch.render import block_render as tbr
from radnerf_tpu_torch.render import switch_render as tsr
from radnerf_tpu_torch.render.render import RenderConfig
from radnerf_tpu_torch.train import other_trainer as tot
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.utils import ckpt as tck

from .fixtures import make_nsvf_dataset
from .test_torch_density_grid import THRESH, _density_tol
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    GRAD_RTOL, GRAD_RTOL_DEFAULT, patched,
)
from .test_torch_single_field import _jax_draws, _sphere

torch.set_num_threads(1)

CFG_KW = dict(scale=0.5, grid_size=16, n_levels=4, log2_T=10, n_experts=2,
              compute_dtype="bfloat16", hash_impl="brick3")
RENDER_KW = dict(samples_per_ray=32, layout="flat", budget_per_ray=64)
N_RAYS = 128
LOSS_W = dict(lambda_opacity=1e-3)
SWITCH_LOSS_W = dict(lambda_opacity=1e-3, lambda_cv_importance=1e-2)
MODELS = {
    "switch": (jswitch.SwitchNGPConfig, jswitch.init_switch_ngp,
               tswitch.SwitchNGPConfig),
    "block": (jblock.BlockNGPConfig, jblock.init_block_ngp,
              tblock.BlockNGPConfig),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(x):
    """One bf16 ulp of |x| (float32 array): 2^(exponent - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


def _models(kind, impl="brick3", structured=False):
    """JAX parameters of `kind` (a table of structure when asked, so that
    densities vary) and a 0.3-sphere occupancy; the port's copies."""
    jc, init, tc = MODELS[kind]
    jcfg = jc(**{**CFG_KW, "hash_impl": impl})
    params = init(jax.random.PRNGKey(0), jcfg)
    if structured:
        rng = np.random.default_rng(0)
        params["hash_table"] = jnp.asarray(rng.uniform(
            -1, 1, params["hash_table"].shape).astype(np.float32))
    state = {**jngp.init_ngp_state(jcfg), "occ": jnp.asarray(_sphere())}
    tp, _ = params_from_jax(_np(params), device="cpu")
    return (jcfg, params, state), (tc(**jcfg.__dict__), tp,
                                   state_from_jax(_np(state), device="cpu"))


def _rays(n=N_RAYS, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _gate_codes(n=N_RAYS, k=2, seed=5):
    rng = np.random.default_rng(seed)
    g = np.exp(rng.normal(size=(n, k)) * 2)
    return (g / g.sum(1, keepdims=True)).astype(np.float32)


def _check_leaves(jg, grads, n_leaves):
    """Each gradient leaf within test_torch_ml_train's GRAD_RTOL of its
    largest entry (the reference's table gradient quantized, the port's
    exact)."""
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == n_leaves
    for (path, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
            GRAD_RTOL_DEFAULT
        scale = np.abs(r).max()
        assert scale > 0 and tuple(g.shape) == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, name


# ------------------------------------------------------------ point gate

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("K,k", [(2, 1), (4, 1), (4, 2)])
def test_point_gate_matches_jax(K, k, train):
    """float32: the top indices equal on every sample, gate and load
    within 1e-5, the gradient of sum(gate c) + sum(load c') w.r.t. both
    MLPs within 1e-4 of each leaf's largest entry (the same f32 sums in
    other orders)."""
    params = jgates.init_point_gate(jax.random.PRNGKey(K + 10 * k), 32, K)
    rng = np.random.default_rng(K + 10 * k)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    c_gate = rng.normal(size=(512, K)).astype(np.float32)
    c_load = rng.normal(size=(K,)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def obj(p):
        g, l, i = jgates.apply_point_gate(p, x, key if train else None,
                                          k=k, train=train)
        return (g * c_gate).sum() + (l * c_load).sum(), (g, l, i)

    (_, (jg, jl, ji)), jgrad = jax.jit(jax.value_and_grad(
        obj, has_aux=True))(params)
    noise = _t(jax.random.normal(key, (512, K)))
    tp, _ = params_from_jax(_np(params), device="cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    g, l, i = tgates.apply_point_gate(tp, _t(x), noise=noise, k=k,
                                      train=train)
    grads = torch.autograd.grad((g * _t(c_gate)).sum()
                                + (l * _t(c_load)).sum(), leaves,
                                allow_unused=True)
    assert g.shape == (512, K) and l.shape == (K,) and i.shape == (512, k)
    flips = (i.numpy() != np.asarray(ji)).any(1)
    assert not flips.any(), "a top index differs"
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(l.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(jl).max())))
    if not train or k >= K:     # the count of nonzero gates
        np.testing.assert_array_equal(
            l.detach().numpy(), (np.asarray(jg) > 0).sum(0))
    jleaves = jax.tree_util.tree_leaves(_np(jgrad))
    assert len(jleaves) == len(grads) == 12
    for r, gr in zip(jleaves, grads):
        gr = np.zeros_like(r) if gr is None else gr.numpy()
        scale = np.abs(r).max()
        assert np.abs(gr - r).max() <= 1e-4 * max(scale, 1e-30)
    # the noise MLP trains only through the load estimate
    noise_grad = sum(float(np.abs(r).max()) for r in jax.tree_util.
                     tree_leaves(_np(jgrad["w_noise"])))
    assert (noise_grad > 0) == (train and k < K)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    vals, idx = tgates.top_k(x, 3)
    ref = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref[0]))


# ---------------------------------------------------------------- fields

def _flip_mask(kind, tp, ts, tcfg, x, params, state, jcfg):
    """Samples whose switch top-1 differs between the port and JAX; each
    must be a near tie of the clean logits (two bf16 ulps of the larger),
    and they are few."""
    if kind != "switch":
        return np.zeros(x.shape[0], bool)
    _, _, gr = tswitch.switch_density(tp, ts, tcfg, _t(x), return_feat=True)
    _, _, jgr = jax.jit(lambda p, x: jswitch.switch_density(
        p, state, jcfg, x, return_feat=True))(params, x)
    flips = gr["indice"].numpy()[:, 0] != np.asarray(jgr["indice"])[:, 0]
    if flips.any():
        feat = tngp.encode_positions(tp["hash_table"], ts, tcfg,
                                     _t(x[flips]))
        clean = tgates.point_gate_logits(tp["gate"], feat, None, 1e-2,
                                         tcfg.cdtype)[0].numpy()
        gap = np.abs(clean[:, 0] - clean[:, 1])
        assert (gap <= 2 * _bf16_ulp(np.abs(clean).max(1))).all()
    assert flips.mean() <= 1e-2
    return flips


@pytest.mark.parametrize("impl", ["xla", "brick3"])
@pytest.mark.parametrize("kind", ["switch", "block"])
def test_density_and_forward_match_jax(kind, impl):
    """sigma within two bf16 ulps of its exponent (_density_tol), rgb
    within 1e-2 (a bf16 sigmoid), the geo features within 2^-7; switch:
    the gate's top-1 equal but for near ties (compared elsewhere)."""
    (jcfg, params, state), (tcfg, tp, ts) = _models(kind, impl, True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.55, 0.55, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = ~_flip_mask(kind, tp, ts, tcfg, x, params, state, jcfg)
    for ind in ([None] if kind == "switch" else [0, 1]):
        if kind == "switch":
            rs, rr, _ = jax.jit(lambda p, x, d: jswitch.switch_forward(
                p, state, jcfg, x, d))(params, x, d)
            sig, rgb, gr = tswitch.switch_forward(tp, ts, tcfg, _t(x), _t(d))
            assert gr["code"].shape == (512, 2) and gr["indice"].shape == (
                512, 1)
            np.testing.assert_array_equal(gr["importance"].numpy(),
                                          gr["code"].numpy().astype(bool)
                                          .sum(0))
        else:
            rs, rr = jax.jit(lambda p, x, d: jblock.block_forward(
                p, state, jcfg, x, d, ind))(params, x, d)
            sig, rgb = tblock.block_forward(tp, ts, tcfg, _t(x), _t(d), ind)
        rs = np.asarray(rs, np.float32)
        assert sig.shape == (512,) and rgb.shape == (512, 3)
        assert (np.abs(sig.float().numpy() - rs) <= _density_tol(rs))[
            keep].all()
        np.testing.assert_allclose(rgb.numpy()[keep], np.asarray(rr)[keep],
                                   rtol=0, atol=1e-2)
    jdens = jswitch.switch_density if kind == "switch" else \
        jblock.block_density
    tdens = tswitch.switch_density if kind == "switch" else \
        tblock.block_density
    ref = jax.jit(lambda p, x: jdens(p, state, jcfg, x, return_feat=True))(
        params, x)
    got = tdens(tp, ts, tcfg, _t(x), return_feat=True)
    r0 = np.asarray(ref[0], np.float32)
    assert (np.abs(got[0].float().numpy() - r0) <= _density_tol(r0))[
        keep].all()
    assert got[1].shape == (512, 16)
    np.testing.assert_allclose(got[1].float().numpy()[keep],
                               np.asarray(ref[1], np.float32)[keep],
                               rtol=2**-7, atol=2**-7)


# ------------------------------------------------------- training renders

def _switch_draws(key, n, budget, K):
    """The draws switch_render_train takes from `key`: k_render, k_gate =
    split(key); the jitter uniform(split(k_render)[0], (N,)); the gate
    noise normal(k_gate, (B, K))."""
    k_render, k_gate = jax.random.split(key)
    k_noise, _ = jax.random.split(k_render)
    return (np.array(jax.random.uniform(k_noise, (n,))),
            np.array(jax.random.normal(k_gate, (n * budget, K))))


# the switch render's leaves in bf16 beyond GRAD_RTOL: the table's
# features reach the loss through three more bf16 layers (the feature
# MLPs) than the single field's, each a bf16 rounding of the cotangent in
# another place on each side (6.5% of the leaf's largest entry seen);
# the noise MLP learns only through the cv term on the load, a sum of
# tiny terms of both signs (4.5% seen). In float32 every leaf agrees
# within 1e-5, which holds the algorithm.
SWITCH_BF16_RTOL = {"hash_table": 8e-2, "w_noise": 6e-2}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_switch_render_train_and_every_gradient_leaf_match_jax(patched,
                                                               dtype):
    """The march exact; the gate's code equal on every slot, its load
    1e-3 of its largest entry; rgb 1e-2, opacity, depth and ws 1e-3 (the
    bf16 MLPs, as the single field's render; 1e-5 in float32); the loss
    (with the cv term) 1e-3 relative (1e-6 in float32); every leaf
    within GRAD_RTOL, or SWITCH_BF16_RTOL, of its largest entry in bf16,
    1e-5 in float32 (hash_impl 'xla', which routes to 'dedup' there on
    both sides)."""
    bf16 = dtype == "bfloat16"
    kw = dict(CFG_KW, compute_dtype=dtype,
              hash_impl="brick3" if bf16 else "xla")
    jcfg, tcfg = jswitch.SwitchNGPConfig(**kw), tswitch.SwitchNGPConfig(**kw)
    params = jswitch.init_switch_ngp(jax.random.PRNGKey(0), jcfg)
    state = {**jngp.init_ngp_state(jcfg), "occ": jnp.asarray(_sphere())}
    tp, _ = params_from_jax(_np(params), device="cpu")
    ts = state_from_jax(_np(state), device="cpu")
    o, d = _rays()
    rng = np.random.default_rng(2)
    target = rng.uniform(0.2, 0.8, (N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rcfg_j, rcfg_t = JRender(**RENDER_KW), RenderConfig(**RENDER_KW)
    noise, gate_noise = _switch_draws(key, N_RAYS, 64, 2)

    def j_loss(p):
        out = jsr.switch_render_train(p, state, jcfg, o, d, key, rcfg_j)
        out["gating_importance"] = out["gating_importance"].astype(
            jnp.float32)
        return j_total_loss(j_nerf_loss(out, {"rgb": target},
                                        **SWITCH_LOSS_W)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    out = tsr.switch_render_train(tp, ts, tcfg, _t(o), _t(d), rcfg_t,
                                  noise=_t(noise), gate_noise=_t(gate_noise))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}, **SWITCH_LOSS_W))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for k in ("ts", "deltas", "valid", "ray_id", "offsets", "cap",
              "rm_samples", "budget_util"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["gating_code"].shape == (N_RAYS * 64, 2)
    np.testing.assert_array_equal(out["gating_code"].detach().numpy(),
                                  np.asarray(ref["gating_code"]))
    assert out["gating_code"].detach().sum(1).eq(1).all()   # pads too
    ri = np.asarray(ref["gating_importance"], np.float32)
    assert np.abs(out["gating_importance"].detach().numpy() - ri).max() \
        <= 1e-3 * np.abs(ri).max()
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0,
                                   atol=atol if bf16 else 1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-3 if bf16 else 1e-6)
    # hash table, gate 2 x (3 w + 3 b), geo 2 x 2, inter 2 x 3, rgb 2 x 3
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == 1 + 12 + 4 + 6 + 6
    for (path, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        tol = next((v for k, v in SWITCH_BF16_RTOL.items() if k in name),
                   GRAD_RTOL_DEFAULT) if bf16 else 1e-5
        scale = np.abs(r).max()
        assert scale > 0 and tuple(g.shape) == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, name


def test_block_render_train_and_every_gradient_leaf_match_jax(patched):
    """A gate of unequal rows (not summing to one on half the rays, so the
    row-sum scaling shows): the march exact; rgb 1e-2, opacity, depth and
    ws 1e-3; the loss 1e-3 relative; every leaf within GRAD_RTOL."""
    (jcfg, params, state), (tcfg, tp, ts) = _models("block")
    o, d = _rays()
    rng = np.random.default_rng(2)
    target = rng.uniform(0.2, 0.8, (N_RAYS, 3)).astype(np.float32)
    gate = _gate_codes()
    gate[::2] *= 0.75
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(jax.random.split(key)[0], (N_RAYS,)))
    rcfg_j, rcfg_t = JRender(**RENDER_KW), RenderConfig(**RENDER_KW)

    def j_loss(p):
        out = jbr.block_render_train(p, state, jcfg, o, d, gate, key, rcfg_j)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **LOSS_W)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    out = tbr.block_render_train(tp, ts, tcfg, _t(o), _t(d), _t(gate),
                                 rcfg_t, noise=_t(noise))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}, **LOSS_W))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for k in ("ts", "deltas", "valid", "ray_id", "rm_samples",
              "budget_util"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(out["rm_samples"]) > 1000
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(out["gating_code"].numpy(), gate)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    _check_leaves(jg, grads, 1 + 4 + 6)


def test_block_closure_refuses_the_dense_layout():
    """The dense layout, once refused, is ported: called without ray_id
    the closure repeats each ray's gate dense_S times (ray-major slots),
    exactly as gathering it by each slot's ray; block_render_train runs
    on the dense layout (held against JAX in test_torch_dense)."""
    _, (tcfg, tp, ts) = _models("block")
    gate = _t(_gate_codes(4))
    fwd = tbr._gated_forward_fn(tp, ts, tcfg, gate, dense_S=3)
    rng = np.random.default_rng(0)
    x = _t(rng.uniform(-0.4, 0.4, (12, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(_t(rng.normal(size=(12, 3)).astype(
        np.float32)), dim=1)
    with torch.no_grad():
        dense = fwd(x, d)
        by_ray = fwd(x, d, ray_id=torch.arange(4).repeat_interleave(3))
    for a, b in zip(dense, by_ray):
        assert torch.equal(a, b)
    with torch.no_grad():
        out = tbr.block_render_train(tp, ts, tcfg, *map(_t, _rays(16)),
                                     _t(_gate_codes(16)),
                                     RenderConfig(layout="dense",
                                                  samples_per_ray=32))
    assert out["ws"].shape == (16, 32) and torch.isfinite(out["rgb"]).all()


# ------------------------------------------------------------ test renders

@contextlib.contextmanager
def _jax_routing(jparams):
    """Within the block the port's switch field (train off) routes each
    sample as the JAX gate does on the same (bit-equal) features: its
    top_k takes the JAX order of the clean bf16 logits. Yields the list
    of each call's (slots, flipped): a sample whose own top-1 differs must
    be a near tie, its two logits within two bf16 ulps of the larger."""
    orig, record = tswitch.apply_point_gate, []
    j_logits = jax.jit(lambda p, f: jgates.apply_mlp(
        p, f, compute_dtype=jnp.bfloat16).astype(jnp.float32))

    def gate(params, feat, noise=None, gen=None, k=1, train=True,
             compute_dtype=torch.float32):
        assert not train and noise is None
        feat_j = jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16)
        clean_j = j_logits(jparams["gate"]["w_gate"], feat_j)
        kk = min(k + 1, clean_j.shape[1])
        idx = _t(jax.lax.top_k(clean_j, kk)[1]).long()
        clean = tgates.point_gate_logits(params, feat, None, 1e-2,
                                         compute_dtype)[0]
        own = tgates.top_k(clean, kk)[1]
        flipped = (own[:, :k] != idx[:, :k]).any(1).numpy()
        if flipped.any():
            c = clean.numpy()[flipped]
            pair = np.take_along_axis(c, idx.numpy()[flipped][:, :2], 1)
            gap = np.abs(pair[:, 0] - pair[:, 1])
            assert (gap <= 2 * _bf16_ulp(np.abs(pair).max(1))).all()
        record.append((feat.shape[0], int(flipped.sum())))
        saved = tgates.top_k
        tgates.top_k = lambda x, n: (x.gather(1, idx[:, :n]), idx[:, :n])
        try:
            return orig(params, feat, noise, gen, k=k, train=train,
                        compute_dtype=compute_dtype)
        finally:
            tgates.top_k = saved

    tswitch.apply_point_gate = gate
    try:
        yield record
    finally:
        tswitch.apply_point_gate = orig


def test_switch_render_test_matches_jax():
    """The port's test render routing as the JAX gate does (_jax_routing:
    its own top-1 differs only on near ties, on at most 1% of the slots):
    the march exact (the same sample count); rgb 1e-2 (a bf16 sigmoid),
    opacity and depth 5e-3 (chip_smoke.py's CPU_TOL): on a table of
    structure the densities reach the bf16 range where one ulp of the
    density logit moves alpha, and the switch's logit passes three more
    bf16 layers (the feature MLP) than the single field's (1e-3 there;
    2.3e-3 seen here)."""
    (jcfg, params, state), (tcfg, tp, ts) = _models("switch",
                                                    structured=True)
    o, d = _rays(64, seed=3)
    ref = jax.jit(lambda p, o, d: jsr.switch_render_test(
        p, state, jcfg, o, d, JRender()))(params, o, d)
    with _jax_routing(params) as calls:
        got = tsr.switch_render_test(tp, ts, tcfg, _t(o), _t(d),
                                     RenderConfig())
    assert len(calls) == got["iterations"] > 1
    assert sum(f for _, f in calls) <= 1e-2 * sum(n for n, _ in calls)
    assert int(got["total_samples"]) == int(ref["total_samples"])
    for k, atol in (("rgb", 1e-2), ("opacity", 5e-3), ("depth", 5e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


def test_block_render_test_matches_the_reference_definition():
    """block_render_test against sum_k g_k JAX render_test(block_forward(
    ind=k)), depth and opacity scaled by the gate's row sum (the
    reference's definition of the block render): rgb 1e-2, opacity and
    depth 1e-3, the same sample count."""
    (jcfg, params, state), (tcfg, tp, ts) = _models("block",
                                                    structured=True)
    o, d = _rays(64, seed=3)
    gate = _gate_codes(64)
    gate[::3] *= 0.5
    refs = [jax.jit(lambda p, o, d, k=k: j_render_test(
        None, state, jcfg, o, d, JRender(),
        forward_fn=lambda x, dd: jblock.block_forward(p, state, jcfg, x, dd,
                                                      k)))(params, o, d)
        for k in range(2)]
    gsum = gate.sum(1)
    rgb = sum(gate[:, k:k + 1] * (np.asarray(refs[k]["rgb"]) - (
        1.0 - np.asarray(refs[k]["opacity"]))[:, None]) for k in range(2)) \
        + (1.0 - np.asarray(refs[0]["opacity"]))[:, None]
    got = tbr.block_render_test(tp, ts, tcfg, _t(o), _t(d), _t(gate),
                                RenderConfig())
    assert int(got["total_samples"]) == int(refs[0]["total_samples"])
    np.testing.assert_allclose(got["rgb"].numpy(), rgb, rtol=0, atol=1e-2)
    for k in ("opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(refs[0][k]) * gsum, rtol=0,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["gating_code"].numpy(), gate)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


def test_jax_block_render_test_fails_on_the_flat_test_layout():
    """The reference's fault: render_test calls the closure without
    ray_id on the flat test layout, so its dense branch repeats the (N,
    K) gate test_block_samples times and cannot reshape to the flat
    buffer's N x test_budget_per_ray rows."""
    (jcfg, params, state), _ = _models("block")
    o, d = _rays(64, seed=3)
    with pytest.raises(TypeError, match="cannot reshape"):
        jbr.block_render_test(params, state, jcfg, o, d, _gate_codes(64),
                              JRender())


# --------------------------------------------------------- moe_render_train

@pytest.mark.parametrize("gate_type", ["position", "ray"])
def test_moe_render_train_matches_jax(patched, gate_type):
    """A zoo of two NGPs (a table each) under the ray gate, each expert's
    jitter from the JAX key's split: the marches exact; rgb 1e-2, opacity
    and depth 1e-3, the gate 1e-5; the loss 1e-3 relative; every leaf of
    the zoo and the gate within GRAD_RTOL."""
    cfg_kw = dict(CFG_KW, shared_encoder=False)
    jcfg = jmngp.MNGPConfig(**cfg_kw)
    params = jmngp.init_mngp(jax.random.PRNGKey(0), jcfg)
    gate = jgates.init_ray_gate(jax.random.PRNGKey(1), 2)
    lin = (np.arange(16) + 0.5) / 16 * 2 - 1
    xx, _, _ = np.meshgrid(lin, lin, lin, indexing="ij")
    occ = np.stack([_sphere(), _sphere() & (xx > 0)[None]])
    state = {**jmngp.init_mngp_state(jcfg), "occ": jnp.asarray(occ)}
    tp, tg = params_from_jax(_np(params), _np(gate), device="cpu")
    ts = state_from_jax(_np(state), device="cpu")
    tcfg = NGPZooConfig(**cfg_kw)
    o, d = _rays()
    target = np.random.default_rng(2).uniform(
        0.2, 0.8, (N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noises = np.stack([np.array(jax.random.uniform(
        jax.random.split(k)[0], (N_RAYS,))) for k in jax.random.split(key, 2)])
    rcfg_j, rcfg_t = JRender(**RENDER_KW), RenderConfig(**RENDER_KW)

    def j_loss(b):
        out = jbr.moe_render_train(b["model"], state, jcfg, b["gate"], o, d,
                                   key, rcfg_j, gate_type=gate_type)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **LOSS_W)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        {"model": params, "gate": gate})
    bundle = {"model": tp, "gate": tg}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    out = tbr.moe_render_train(tp, ts, tcfg, tg, _t(o), _t(d), rcfg_t,
                               gate_type=gate_type, noises=_t(noises))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}, **LOSS_W))
    grads = torch.autograd.grad(loss, tree_leaves(bundle))
    for k in ("ts", "deltas", "valid", "rm_samples", "total_samples"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["depth"].shape == (N_RAYS, 2)
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3), ("gating_code", 1e-5),
                    ("gating_importance", 1e-4)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    _check_leaves(jg, grads, 1 + 4 + 6 + 10)


# ------------------------------------------------- anchors, gate, grid

def test_kmeans_cameras_and_spatial_gating_match_jax():
    """k-means bit-equal (the same numpy code and draws); the spatial gate
    within 1e-6 (float32 softmax), one-hot as overlap_ratio -> 0."""
    rng = np.random.default_rng(0)
    cams = rng.normal(size=(40, 3)).astype(np.float32)
    cams[:20] += 3.0
    for k in (2, 3):
        a = tot.kmeans_cameras(cams.copy(), k)
        np.testing.assert_array_equal(a, jot.kmeans_cameras(cams.copy(), k))
    anchors = tot.kmeans_cameras(cams.copy(), 2)
    o = rng.normal(size=(64, 3)).astype(np.float32) * 2
    for ratio in (0.25, 4.0, 0.0):
        ns = types.SimpleNamespace(anchors=jnp.asarray(anchors),
                                   h=types.SimpleNamespace(
                                       overlap_ratio=ratio))
        ref = np.asarray(jot.OtherNeRFSystem.spatial_gating(ns,
                                                            jnp.asarray(o)))
        got = tot.spatial_gating(_t(o), _t(anchors), ratio).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ((got == 0) | (got == 1)).all()


@pytest.mark.parametrize("kind", ["switch", "block"])
def test_update_density_grid_with_the_models_densities(kind):
    """The warmup update with each model's density_fn (the switch field
    through its clean gate, the shared block density), the JAX key's
    draws handed in: densities within two bf16 ulps of their exponent
    (_density_tol) but at switch cells whose top-1 flipped on a near tie
    (_flip_mask), then a later update on its once-drawn cells."""
    (jcfg, params, state), (tcfg, tp, _) = _models(kind, structured=True)
    jdens = jswitch.switch_density if kind == "switch" else \
        jblock.block_density
    state0 = jngp.init_ngp_state(jcfg)
    upd = jax.jit(lambda p, s, k, w: jngp.update_density_grid(
        p, s, jcfg, k, THRESH, w,
        density_fn=lambda x: jdens(p, s, jcfg, x)), static_argnums=3)
    dfn = tot.other_density_fn(kind)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    warm = upd(params, state0, k1, True)
    ts0 = state_from_jax(_np(state0), device="cpu")
    draws = _jax_draws(k1, state0["density_grid"], jcfg, True)
    got = tngp.update_density_grid(tp, ts0, tcfg, None, THRESH, True,
                                   dfn(tp, ts0, tcfg), draws=draws)
    rg, gg = np.asarray(warm["density_grid"])[0], got["density_grid"][0]
    xyz = tngp.cell_world_positions(tngp.all_cell_coords(tcfg, "cpu"), 0,
                                    tcfg, jitter=draws[0]["jitter"]).numpy()
    keep = ~_flip_mask(kind, tp, ts0, tcfg, xyz, params, state0, jcfg)
    assert (np.abs(gg.numpy() - rg) <= _density_tol(rg))[keep].all()
    assert 0.05 < got["occ"].float().mean() < 0.95
    later = upd(params, warm, k2, False)
    tw = state_from_jax(_np(warm), device="cpu")
    draws = _jax_draws(k2, warm["density_grid"], jcfg, False)
    got = tngp.update_density_grid(tp, tw, tcfg, None, THRESH, False,
                                   dfn(tp, tw, tcfg), draws=draws)
    flat = tngp._sample_cells(None, tw["density_grid"][0], 1024, THRESH, 16,
                              draws[0]).numpy()
    times = np.bincount(flat, minlength=4096)
    rg, gg = np.asarray(later["density_grid"])[0], got["density_grid"][0]
    never = times == 0
    np.testing.assert_array_equal(gg.numpy()[never], rg[never])
    assert never.sum() > 500


def test_switch_and_block_trees_round_trip():
    """The switch tree (table, stacked inter, gate{w_gate, w_noise}, geo,
    rgb) and the block tree (stacked rgb) through convert both ways and
    through _copy_into in both directions, bit for bit."""
    for kind in MODELS:
        (_, params, _), (_, tp, _) = _models(kind)
        back, gate = params_to_jax(tp)
        assert gate is None
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(_np(params))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, np.asarray(b))
        # a JAX tree into the port's tensors, and the port's numpy tree
        # into tensors of the JAX tree's structure
        for src in (_np(params), back):
            dst = params_from_jax(_np(jax.tree_util.tree_map(
                jnp.zeros_like, params)), device="cpu")[0]
            tt._copy_into(dst, src, "params")
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(dst),
                                                         tree_leaves(tp)))
    (_, sp, _), _ = _models("switch")
    (_, bp, _), _ = _models("block")
    assert bp["rgb"]["w"][0].shape == (2, 32, 64)
    assert sp["inter"]["w"][0].shape == (2, 8, 64)
    with pytest.raises(ValueError):
        tt._copy_into(params_from_jax(_np(bp), device="cpu")[0], _np(sp),
                      "params")


# ------------------------------------------------------- the NeRFSystem

SMALL = dict(grid_size=32, n_levels=4, hash_impl="brick3")
RUN = ("Synthetic_NeRF", "TestSphere")
JCFG = {"switch": jswitch.SwitchNGPConfig, "block": jblock.BlockNGPConfig}


def _args(root, exp, kind, *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", RUN[0], "--scene_name", RUN[1],
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "256", "--num_epochs", "2",
            "--steps_per_epoch", "9", "--num_devices", "1",
            "--samples_per_ray", "48", "--val_chunk", "1024",
            "--no_save_test", "--model_type", kind, "--model_zoo_size", "2",
            "--gate_type", "point", "--cv_loss_w", "1e-4", *extra]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The fixture scene, a working directory, and the port's configs cut
    to 32^3 grids and 4 levels with brick3 pinned."""
    root = make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tot, "SwitchNGPConfig",
                   functools.partial(tot.SwitchNGPConfig, **SMALL))
        mp.setattr(tot, "BlockNGPConfig",
                   functools.partial(tot.BlockNGPConfig, **SMALL))
        os.chdir(work)
        try:
            yield root, work
        finally:
            os.chdir(cwd)


def _pair(workdir, kind):
    """The port's and the JAX package's OtherNeRFSystem of `kind` from
    the same flags, in float32 (--no-adaptive_budget on the JAX side),
    the port holding the JAX system's parameters, both a sphere
    occupancy."""
    root, work = workdir
    os.chdir(work)
    f32 = ("--compute_dtype", "float32")
    port = tot.OtherNeRFSystem(get_opts(_args(root, f"port_{kind}", kind,
                                              *f32)), device="cpu")
    port.setup()
    jsys = jot.OtherNeRFSystem(get_opts(_args(
        root, f"jax_{kind}", kind, "--no-adaptive_budget", *f32)))
    jsys.cfg = JCFG[kind](scale=0.5, log2_T=11, n_experts=2,
                          compute_dtype="float32", **SMALL)
    jsys.setup()
    occ = _sphere(32)
    jsys.model_state = {**jsys.model_state, "occ": jnp.asarray(occ)}
    tr = port.trainer
    tr.model_state["occ"].copy_(torch.from_numpy(occ))
    tt._copy_into(tr.bundle["model"], _np(jsys.params), "params")
    return port, jsys


@pytest.fixture(scope="module")
def switch_pair(workdir):
    return _pair(workdir, "switch")


@pytest.fixture(scope="module")
def block_pair(workdir):
    return _pair(workdir, "block")


def _step_batch(jsys, kind, key, budget):
    """256 rays of the fixture's store and the draws the JAX loss takes
    from the step's `key` (the jitter; switch: the gate noise of every
    slot, (N, budget, K) in the batch)."""
    rng = np.random.default_rng(0)
    n_img, n_pix = jsys.data["rays"].shape[:2]
    b = {"img_idxs": rng.integers(0, n_img, 256).astype(np.int32),
         "pix_idxs": rng.integers(0, n_pix, 256).astype(np.int32)}
    tb = {"img_idxs": _t(b["img_idxs"]).long(),
          "pix_idxs": _t(b["pix_idxs"]).long()}
    if kind == "switch":
        noise, gate_noise = _switch_draws(key, 256, budget, 2)
        tb["gate_noise"] = _t(gate_noise.reshape(256, budget, 2))
    else:
        noise = np.array(jax.random.uniform(jax.random.split(key)[0],
                                            (256,)))
    tb["noise"] = _t(noise)
    return b, tb


@pytest.mark.parametrize("kind", ["switch", "block"])
def test_system_adam_step_matches_the_jax_system(kind, switch_pair,
                                                 block_pair, patched):
    """One Adam step of one 256-ray slice against the JAX OtherNeRFSystem's
    train_step (its key handed to the loss unfolded), both systems in
    float32 (brick3 routes to 'dedup' there on both sides; the bf16
    render and its every leaf are held above): the same march, the loss
    and PSNR within 1e-5 relative. Adam's first update of a parameter is
    -lr g / (|g| + 1e-15), monotone in g: each parameter, the port's and
    the JAX one, must move as from a gradient within 5e-3 of the leaf's
    largest entry of the port's (test_torch_ml_train's float32 step: sums
    in other orders that cancel in the first layers), up to 1e-4 lr of
    float32 rounding. The JAX aux lacks budget_util (the reference fault
    at step 15); the port's carries it."""
    port, jsys = switch_pair if kind == "switch" else block_pair
    tr = port.trainer
    assert not port.moe and set(tr.bundle) == {"model"}
    assert tr.buckets == tt.BUDGET_BUCKETS
    key = jax.random.PRNGKey(4)
    b, tb = _step_batch(jsys, kind, key, tr.rcfg.budget_per_ray)
    trainable, ost = jax.tree_util.tree_map(
        jnp.copy, (jsys.trainable, jsys.opt_state))
    new, _, jl, jaux = jsys.train_step(trainable, ost, jsys.model_state,
                                       jsys._shard(b), jsys.data, key)
    assert "budget_util" not in jaux
    before = [p.detach().clone() for p in tree_leaves(tr.bundle)]
    loss, aux = tr.train_step(tb)
    try:
        assert float(aux["rm_samples"]) == float(jaux["rm_samples"]) > 0
        assert 0 < float(aux["budget_util"]) <= 1
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                                   rtol=1e-5)
        lr = tt.lr_schedule(tr.tcfg, 0)
        adam = lambda g: g / (np.abs(g) + 1e-15)
        jnew = jax.tree_util.tree_leaves(_np(new["model"]))
        for path, p0, p1, r1 in zip(tree_paths(tr.bundle), before,
                                    tree_leaves(tr.bundle), jnew):
            g = p1.grad.numpy().astype(np.float64)
            delta = 5e-3 * np.abs(g).max()
            for moved in ((p0 - p1.detach()).numpy(), p0.numpy() - r1):
                u = moved / lr
                assert ((u >= adam(g - delta) - 1e-4)
                        & (u <= adam(g + delta) + 1e-4)).all(), path
    finally:
        with torch.no_grad():
            for p, s in zip(tree_leaves(tr.bundle), before):
                p.copy_(s)
        tr.optimizer.state.clear()
        tr.global_step = 0


@pytest.mark.parametrize("kind", ["switch", "block"])
def test_checkpoints_resume_both_ways(kind, switch_pair, block_pair,
                                      tmp_path):
    """The port's file (no gate_params, the resolved hash impl recorded)
    resumes in the JAX system (parameters, grids and step; the port's
    plain Adam dict takes the JAX "structure mismatch" branch), and a JAX
    file with optax's Adam state after two updates resumes in the port
    with its moments."""
    port, jsys = switch_pair if kind == "switch" else block_pair
    port.trainer.global_step = 3
    port.save_checkpoint(0)
    port.trainer.global_step = 0
    path = os.path.join(port.ckpt_dir, "epoch=0.ckpt")
    ck = tck.load_ckpt(path)
    assert "gate_params" not in ck
    assert ck["hparams"]["resolved_hash_impl"] == "brick3"
    before = jsys.params, jsys.opt_state, jsys.model_state, jsys.global_step
    try:
        jsys.resume(path)
        for a, b in zip(tree_leaves(port.params),
                        jax.tree_util.tree_leaves(jsys.params)):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        assert jsys.global_step == 3
        np.testing.assert_array_equal(np.asarray(jsys.model_state["occ"]),
                                      port.model_state["occ"].numpy())
    finally:
        (jsys.params, jsys.opt_state, jsys.model_state,
         jsys.global_step) = before
        jsys.trainable = jsys._bundle_params()

    bundle = jsys._bundle_params()
    ost = jsys.optimizer.init(bundle)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32) * 1e-2, bundle)
        upd, ost = jsys.optimizer.update(g, ost, bundle)
        bundle = jax.tree_util.tree_map(lambda p, u: p + u, bundle, upd)
    jpath = str(tmp_path / "epoch=0.ckpt")
    jck.save_ckpt(jpath, {
        "params": bundle["model"], "opt_state": ost,
        "model_state": jsys.model_state, "step": 9,
        "hparams": {"resolved_hash_impl": "brick3"}})
    system = tot.OtherNeRFSystem(get_opts(_args(port.h.root_dir,
                                                f"from_jax_{kind}", kind)),
                                 device="cpu")
    system.setup()
    system.resume(jpath)
    assert system.global_step == 9 and system.gate_params is None
    opt = system.trainer.optimizer
    for p, want, m in zip(tree_leaves(system.trainer.bundle),
                          jax.tree_util.tree_leaves(bundle),
                          jax.tree_util.tree_leaves(ost[0].mu)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want))
        assert float(opt.state[p]["step"]) == 2
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                      np.asarray(m))
    if kind == "block":           # anchors from the cameras, not the file
        np.testing.assert_array_equal(system.anchors.numpy(),
                                      np.asarray(jsys.anchors))
    system.close()


# -------------------------------------------------------- the entry point

@pytest.mark.parametrize("kind", ["switch", "block", "mega"])
def test_train_other_main_trains_past_step_16(kind, workdir):
    """train_other.main on the CPU with the adaptive budget on (the
    default): 18 steps (the JAX system fails at step 15, reading
    budget_util), a validation at the last epoch (the JAX block system
    fails at its first) and checkpoints; switch then resumes with
    --resume auto for one more epoch from step 18."""
    root, work = workdir
    os.chdir(work)
    seen = []
    system = train_other.main(
        _args(root, f"main_{kind}", kind), device="cpu",
        on_step=lambda s, loss, aux: seen.append(
            (s, float(loss), float(aux["budget_util"]))))
    assert [s for s, _, _ in seen] == list(range(18))
    assert all(np.isfinite(v) and 0 < u <= 1 for _, v, u in seen)
    assert system.h.adaptive_budget and system.trainer.last_budget_util > 0
    assert type(system.cfg).__name__ == (
        "SwitchNGPConfig" if kind == "switch" else "BlockNGPConfig")
    assert system.cfg.hash_impl == "brick3" and not system.moe
    assert (system.anchors is None) == (kind == "switch")
    system.close()
    d = os.path.join("ckpts", *RUN, f"main_{kind}")
    assert sorted(os.listdir(d)) == ["epoch=0.ckpt", "epoch=1.ckpt",
                                     "epoch=1_slim.ckpt"]
    with open(os.path.join("logs", *RUN, f"main_{kind}",
                           "metrics.jsonl")) as f:
        psnr = [json.loads(line)["value"] for line in f
                if '"test/psnr"' in line]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    if kind != "switch":
        return
    again = train_other.main(
        _args(root, f"main_{kind}", kind, "--num_epochs", "3", "--resume",
              "auto"), device="cpu")
    assert again.global_step == 27
    assert int(tck.load_ckpt(os.path.join(d, "epoch=2.ckpt"))["step"]) == 27
    again.close()


def test_train_other_refuses_what_jax_refuses(workdir):
    root, work = workdir
    os.chdir(work)
    with pytest.raises(AssertionError,
                       match="--model_type must be switch|block|mega"):
        train_other.main(_args(root, "bad", "ngp"), device="cpu")
    with pytest.raises(ValueError, match="ckpt_path"):
        train_other.main(_args(root, "bad", "switch", "--val_only"),
                         device="cpu")
