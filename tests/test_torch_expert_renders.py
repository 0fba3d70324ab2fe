"""PyTorch port vs the JAX package, the MoE renders other than the union
one, at test_torch_ml_train's size (zoo=2, G=16, L=4, T=2^10, bf16,
brick3, the flat layout): `ml_render_train` and `ml_render_test` with
union_sampling=False (each expert marches its own grid, the start jitter
shifted by k/K, one shared encode of the K sample sets) and with
shared_encoder=False (unshared_MNGP: one hash table per expert, K
single-field renders); `mngp_forward_all` against `mngp_forward_expert`
and JAX; the grid update over per-expert tables.

The JAX Pallas backwards run in interpret mode (test_torch_ml_train's
`patched`); each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.models import mngp as jmngp
from radnerf_tpu.models.gates import init_ray_gate as j_init_gate
from radnerf_tpu.render.ml_render import ml_render_test as j_ml_render_test
from radnerf_tpu.render.ml_render import ml_render_train as j_ml_render_train
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.losses import nerf_loss, total_loss
from radnerf_tpu_torch.models import mngp as tmngp
from radnerf_tpu_torch.parallel.step import tree_leaves
from radnerf_tpu_torch.render.ml_render import ml_render_test, ml_render_train
from radnerf_tpu_torch.render.render import RenderConfig

from .test_torch_density_grid import THRESH, _density_tol, _jax_draws
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    CFG_KW, GRAD_RTOL, GRAD_RTOL_DEFAULT, LOSS_W, patched,
)

torch.set_num_threads(1)

RENDER_KW = dict(samples_per_ray=32, layout="flat", budget_per_ray=64)
# (config, render) of each path: the shared table without union sampling,
# and one table per expert
PATHS = {
    "per_expert": (dict(CFG_KW), dict(union_sampling=False)),
    "unshared": (dict(CFG_KW, shared_encoder=False), {}),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(cfg_kw, structured=False):
    """JAX init_mngp and gate parameters, expert 0 occupying a 0.3-radius
    sphere and expert 1 its +x half; the port's copies."""
    jcfg = jmngp.MNGPConfig(**cfg_kw)
    params = jmngp.init_mngp(jax.random.PRNGKey(0), jcfg)
    if structured:
        rng = np.random.default_rng(0)
        params["hash_table"] = jnp.asarray(rng.uniform(
            -1, 1, params["hash_table"].shape).astype(np.float32))
    gate = j_init_gate(jax.random.PRNGKey(1), jcfg.n_experts)
    lin = (np.arange(16) + 0.5) / 16 * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3
    state = {**jmngp.init_mngp_state(jcfg),
             "occ": jnp.asarray(np.stack([sphere, sphere & (xx > 0)])[:, None])}
    tp, tg = params_from_jax(_np(params), _np(gate), device="cpu")
    return (jcfg, params, gate, state), (
        tmngp.MNGPConfig(**cfg_kw), tp, tg,
        state_from_jax(_np(state), device="cpu"))


def _rays(n=128, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("path", list(PATHS))
def test_ml_render_train_and_every_gradient_leaf_match_jax(patched, path):
    cfg_kw, rkw = PATHS[path]
    (jcfg, params, gate, state), (tcfg, tp, tg, ts) = _models(cfg_kw)
    rcfg_j = JRender(**RENDER_KW, **rkw)
    rcfg_t = RenderConfig(**RENDER_KW, **rkw)
    o, d = _rays()
    rng = np.random.default_rng(2)
    noise = rng.random(128).astype(np.float32)
    target = rng.uniform(0.2, 0.8, (128, 3)).astype(np.float32)

    def j_loss(bundle):
        out = j_ml_render_train(bundle["model"], state, jcfg, bundle["gate"],
                                o, d, d, jax.random.PRNGKey(3), rcfg_j,
                                noise=noise)
        return j_total_loss(j_nerf_loss(out, {"rgb": target}, **LOSS_W)), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        {"model": params, "gate": gate})
    bundle = {"model": tp, "gate": tg}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    out = ml_render_train(tp, ts, tcfg, tg, _t(o), _t(d), _t(d), rcfg_t,
                          noise=_t(noise))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}, **LOSS_W))
    grads = torch.autograd.grad(loss, tree_leaves(bundle))
    # each expert's march is exact: the same samples in the same slots
    # (expert 1's jitter is mod(noise + 1/2, 1) on both sides)
    for k in ("ts", "deltas", "valid", "rm_samples", "total_samples"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["ts"].shape == (2, 128 * 64) and out["ray_id"].shape == (
        2, 128 * 64)
    assert not torch.equal(out["ts"][0], out["ts"][1])
    # the shared per-expert render measures no buffer use (0, as the
    # reference); the unshared renders' mean
    np.testing.assert_array_equal(out["budget_util"].numpy(),
                                  np.asarray(ref["budget_util"]))
    assert (float(out["budget_util"]) == 0.0) == (path == "per_expert")
    # the bf16 MLPs, as in test_torch_ml_train: rgb 1e-2 (one bf16 ulp of
    # a sigmoid is ~4e-3), opacity and depth 1e-3, the gate 1e-5; the loss
    # 1e-3 relative; each gradient leaf within GRAD_RTOL of its largest
    for k, atol in (("rgb", 1e-2), ("independent_rgbs", 1e-2),
                    ("opacity", 1e-3), ("depth", 1e-3), ("ws", 1e-3),
                    ("gating_code", 1e-5)):
        got = out[k].detach().numpy()
        assert got.shape == np.shape(ref[k]), k
        np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == 1 + 2 * 2 + 2 * 3 + 2 * 5
    for (p, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(p)
        tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
            GRAD_RTOL_DEFAULT
        scale = np.abs(r).max()
        assert scale > 0 and g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, name


@pytest.mark.parametrize("path", list(PATHS))
def test_ml_render_test_matches_jax(path):
    cfg_kw, rkw = PATHS[path]
    (jcfg, params, gate, state), (tcfg, tp, tg, ts) = _models(cfg_kw)
    o, d = _rays(64, seed=4)
    ref = jax.jit(lambda p, g, o, d: j_ml_render_test(
        p, state, jcfg, g, o, d, d, JRender(**rkw)))(params, gate, o, d)
    got = ml_render_test(tp, ts, tcfg, tg, _t(o), _t(d), _t(d),
                         RenderConfig(**rkw))
    # each expert's march is exact; the features and MLPs as in
    # test_torch_ml_render (rgb 1e-2, opacity and depth 1e-4, the gate
    # 1e-5)
    assert int(got["total_samples"]) == int(ref["total_samples"])
    for k, atol in (("rgb", 1e-2), ("independent_rgbs", 1e-2),
                    ("opacity", 1e-4), ("depth", 1e-4),
                    ("gating_code", 1e-5), ("gating_importance", 1e-3)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3
    assert got["iterations"] > 2
    assert float(got["depth"][:, 1].sum()) < float(got["depth"][:, 0].sum())


@pytest.mark.parametrize("shared", [True, False])
def test_forward_all_is_each_expert_and_matches_jax(shared):
    cfg_kw = dict(CFG_KW, shared_encoder=shared)
    (jcfg, params, _, state), (tcfg, tp, _, ts) = _models(cfg_kw, True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sig, rgb = tmngp.mngp_forward_all(tp, ts, tcfg, _t(x), _t(d))
    assert sig.shape == (2, 300) and rgb.shape == (2, 300, 3)
    for k in range(2):
        s_k, r_k = tmngp.mngp_forward_expert(tp, ts, tcfg, _t(x), _t(d), k)
        # the same encode and MLP weights: equal to the batched form
        # within one bf16 rounding of the matmuls (batched vs one expert)
        np.testing.assert_allclose(s_k.float().numpy(),
                                   sig[k].float().numpy(), rtol=2**-6)
        np.testing.assert_allclose(r_k.numpy(), rgb[k].numpy(), rtol=0,
                                   atol=1e-2)
        fwd = tmngp.expert_forward_fn(
            tp["hash_table"] if shared else tp["hash_table"][k],
            tmngp.slice_stacked(tp["geo"], k),
            tmngp.slice_stacked(tp["rgb"], k), ts, tcfg)
        s_f, r_f = fwd(_t(x), _t(d))
        assert torch.equal(s_f, s_k) and torch.equal(r_f, r_k)
    rs, rr = jax.jit(lambda p, x, d: jmngp.mngp_forward_all(
        p, state, jcfg, x, d))(params, x, d)
    # against JAX: sigma within two bf16 ulps of its exponent, rgb 1e-2
    rs = np.asarray(rs, np.float32)
    assert (np.abs(sig.float().numpy() - rs) <= _density_tol(rs)).all()
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rr), rtol=0,
                               atol=1e-2)


def test_unshared_grid_update_matches_jax():
    """Warmup update of two experts with their own tables (each expert's
    density through its own table, packed once): within two bf16 ulps of
    each density's exponent, as test_torch_density_grid."""
    cfg_kw = dict(CFG_KW, shared_encoder=False)
    (jcfg, params, _, _), (tcfg, tp, _, _) = _models(cfg_kw, True)
    state = jmngp.init_mngp_state(jcfg)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda p, s, k: jmngp.mngp_update_density_grids(
        p, s, jcfg, k, THRESH, True))(params, state, key)
    got = tmngp.mngp_update_density_grids(
        tp, state_from_jax(_np(state), device="cpu"), tcfg, None, THRESH,
        True, draws=_jax_draws(key, state["density_grid"], jcfg, True))
    rg, gg = np.asarray(ref["density_grid"]), got["density_grid"].numpy()
    assert (np.abs(gg - rg) <= _density_tol(rg)).all()
    assert (gg == rg).mean() > 0.8
    # two tables: two different grids
    assert not np.array_equal(gg[0], gg[1])
