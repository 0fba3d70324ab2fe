"""PyTorch port vs the JAX package, the single NGP field (train.py's
Instant-NGP baseline) at a small size (scale 0.5, G=16 or 32, L=4,
T=2^10-2^11, bf16): the field's forward and density (hash_impl 'xla' and
'brick3'), the flat training march (bit-equal), the flat training render
with its outputs and every gradient leaf, the flat test render, the grid
update with the JAX key's draws handed in, NGPZooConfig; then the
single-field NeRFSystem on the NSVF fixture scene: one step against the
JAX NeRFSystem's own `_loss_fn` (the per-ray jitter its key folds in is
handed to the port), five Adam steps against its `train_step`,
checkpoints both ways, and the --ckpt_backend orbax writer.

The JAX Pallas backwards run in interpret mode (test_torch_ml_train's
`patched`). Each test states its tolerance.
"""

import functools
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.models import ngp as jngp
from radnerf_tpu.models import zoo as jzoo
from radnerf_tpu.ops import marching as jm
from radnerf_tpu.ops.intersection import scene_near_far
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu.render.render import render_test as j_render_test
from radnerf_tpu.render.render import render_train as j_render_train
from radnerf_tpu.train.trainer import NeRFSystem as JNeRFSystem
from radnerf_tpu.utils import ckpt as jck
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.losses import nerf_loss, total_loss
from radnerf_tpu_torch.models import ngp as tngp
from radnerf_tpu_torch.models import zoo as tzoo
from radnerf_tpu_torch.ops import marching as tm
from radnerf_tpu_torch.opt import get_opts
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves,
)
from radnerf_tpu_torch.render.render import (
    RenderConfig, render_test, render_train,
)
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.utils import ckpt as tck

from .fixtures import make_nsvf_dataset
from .test_torch_density_grid import THRESH, _density_tol
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    GRAD_RTOL, GRAD_RTOL_DEFAULT, patched,
)
from .test_torch_train_ops import UNION_KEYS, _union_setup

torch.set_num_threads(1)

CFG_KW = dict(scale=0.5, grid_size=16, n_levels=4, log2_T=10,
              compute_dtype="bfloat16", hash_impl="brick3")
RENDER_KW = dict(samples_per_ray=32, layout="flat", budget_per_ray=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(g=16):
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    return (np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3)[None]


def _field(impl="brick3", structured=False):
    """JAX init_ngp parameters (a table of structure when asked, so that
    the densities vary) and a sphere occupancy; the port's copies."""
    jcfg = jngp.NGPConfig(**{**CFG_KW, "hash_impl": impl})
    params = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    if structured:
        rng = np.random.default_rng(0)
        params["hash_table"] = jnp.asarray(rng.uniform(
            -1, 1, params["hash_table"].shape).astype(np.float32))
    state = {**jngp.init_ngp_state(jcfg), "occ": jnp.asarray(_sphere())}
    tp, _ = params_from_jax(_np(params), device="cpu")
    return (jcfg, params, state), (tngp.NGPConfig(**jcfg.__dict__), tp,
                                   state_from_jax(_np(state), device="cpu"))


def _rays(n=64, seed=0, spread=0.1):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * spread
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "brick3"])
def test_ngp_forward_and_density_match_jax(impl):
    (jcfg, params, state), (tcfg, tp, ts) = _field(impl, structured=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.55, 0.55, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rs, rr = jax.jit(lambda p, x, d: jngp.ngp_forward(p, state, jcfg, x, d))(
        params, x, d)
    sig, rgb = tngp.ngp_forward(tp, ts, tcfg, _t(x), _t(d))
    # sigma = exp of a bf16 MLP output, which may round one bf16 ulp apart
    # (the encode within one bf16 ulp, f32 sums in other orders): two ulps
    # of |h|; rgb is a bf16 sigmoid (ulp 2^-8 on [0.5, 1)): 1e-2
    rs = np.asarray(rs, np.float32)
    assert sig.shape == (512,) and rgb.shape == (512, 3)
    assert (np.abs(sig.float().numpy() - rs) <= _density_tol(rs)).all()
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rr), rtol=0,
                               atol=1e-2)
    # the density alone, with the grid update's impl, and its features
    ref = jax.jit(lambda p, x: jngp.ngp_density(
        p, state, jcfg, x, return_feat=True, impl="xla"))(params, x)
    got = tngp.ngp_density(tp, ts, tcfg, _t(x), return_feat=True, impl="xla")
    r0 = np.asarray(ref[0], np.float32)
    assert (np.abs(got[0].float().numpy() - r0) <= _density_tol(r0)).all()
    assert got[1].shape == (512, 16)
    np.testing.assert_allclose(got[1].float().numpy(),
                               np.asarray(ref[1], np.float32), rtol=2**-7,
                               atol=2**-7)


@pytest.mark.parametrize("budget,cap", [(64, 192), (8, 32)])
def test_march_rays_train_flat_is_bit_equal(budget, cap):
    """N=64 rays, 1024 candidates each (the reference's Pallas occupancy
    kernel); budget 8 saturates the buffer (front truncation)."""
    jc, tc = (jm.MarchConfig(scale=0.5, grid_size=32, samples_per_ray=cap),
              tm.MarchConfig(scale=0.5, grid_size=32, samples_per_ray=cap))
    o, d, occ, noise = _union_setup()
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    t1, t2 = (np.asarray(a) for a in jax.jit(scene_near_far)(o, d, c, h))
    ref = jax.jit(lambda o, d, t1, t2, occ, nz: jm.march_rays_train_flat(
        o, d, t1, t2, occ, jc, nz, budget_per_ray=budget))(
        o, d, t1, t2, occ[0], noise)
    got = tm.march_rays_train_flat(*map(_t, (o, d, t1, t2, occ[0])), tc,
                                   _t(noise), budget_per_ray=budget)
    for key in UNION_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert int(got["total"]) > 0
    if budget == 8:      # the global budget truncated rays at the front
        big = tm.march_rays_train_flat(*map(_t, (o, d, t1, t2, occ[0])), tc,
                                       _t(noise), budget_per_ray=64)
        assert (got["cap"] <= big["cap"]).all()
        assert (got["cap"] < big["cap"]).sum() > 10


def _j_render_loss(jcfg, state, rcfg, o, d, noise, target):
    def loss(p):
        out = j_render_train(p, state, jcfg, o, d, jax.random.PRNGKey(3),
                             rcfg, noise=noise)
        return j_total_loss(j_nerf_loss(out, {"rgb": target})), out
    return loss


def test_render_train_outputs_and_every_gradient_leaf_match_jax(patched):
    (jcfg, params, state), (tcfg, tp, ts) = _field()
    o, d = _rays(128)
    rng = np.random.default_rng(2)
    noise = rng.random(128).astype(np.float32)
    target = rng.uniform(0.2, 0.8, (128, 3)).astype(np.float32)
    rcfg_j, rcfg_t = JRender(**RENDER_KW), RenderConfig(**RENDER_KW)
    (jl, ref), jg = jax.jit(jax.value_and_grad(
        _j_render_loss(jcfg, state, rcfg_j, o, d, noise, target),
        has_aux=True))(params)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    out = render_train(tp, ts, tcfg, _t(o), _t(d), rcfg_t, noise=_t(noise))
    loss = total_loss(nerf_loss(out, {"rgb": _t(target)}))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    # the march is exact: the same samples in the same slots
    for k in ("ts", "deltas", "valid", "ray_id", "offsets", "cap",
              "n_samples", "rm_samples", "total_samples", "budget_util"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(out["rm_samples"]) > 1000
    # the bf16 MLPs as in test_torch_ml_render: rgb 1e-2, opacity and
    # depth 1e-3 (sigma one bf16 ulp apart moves them little); the loss
    # relative 1e-3
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3),
                    ("ws", 1e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    # each leaf within test_torch_ml_train's GRAD_RTOL of its largest
    # entry (the reference's table gradient quantized, the port's exact)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(grads) == 1 + 2 * 2 + 2 * 3
    for (path, r), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
            GRAD_RTOL_DEFAULT
        scale = np.abs(r).max()
        assert scale > 0 and g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol * scale, name


def test_render_train_forward_fn_ray_id_and_extras():
    """A closure that takes the samples' ray ids, and returns a third
    item, comes back as gate_results; the default field is the same
    render."""
    _, (tcfg, tp, ts) = _field()
    o, d = map(_t, _rays(32))
    rcfg = RenderConfig(**RENDER_KW)
    noise = torch.rand(32, generator=torch.Generator().manual_seed(0))
    seen = {}

    def fwd(x, dd, ray_id):
        seen["ray_id"] = ray_id
        s, c = tngp.ngp_forward(tp, ts, tcfg, x, dd)
        return s, c, x[:, :1]

    with torch.no_grad():
        out = render_train(None, ts, tcfg, o, d, rcfg, forward_fn=fwd,
                           noise=noise, forward_takes_ray_id=True)
        ref = render_train(tp, ts, tcfg, o, d, rcfg, noise=noise)
    assert torch.equal(seen["ray_id"], out["ray_id"])
    assert out["gate_results"].shape == (out["ts"].shape[0], 1)
    assert torch.equal(out["rgb"], ref["rgb"]) and "gate_results" not in ref
    # the dense layout, once refused: the closure sees every slot without
    # ray_id (test_torch_dense holds the render against JAX)
    with torch.no_grad():
        dense = render_train(None, ts, tcfg, o, d, RenderConfig(
            layout="dense", samples_per_ray=32),
            forward_fn=lambda x, dd, ray_id=None: fwd(x, dd, ray_id),
            noise=noise, forward_takes_ray_id=True)
    assert seen["ray_id"] is None and dense["ws"].shape == (32, 32)
    assert dense["gate_results"].shape == (32 * 32, 1)


def test_render_test_matches_jax():
    (jcfg, params, state), (tcfg, tp, ts) = _field(structured=True)
    o, d = _rays(64, seed=3)
    ref = jax.jit(lambda p, o, d: j_render_test(p, state, jcfg, o, d,
                                                JRender()))(params, o, d)
    got = render_test(tp, ts, tcfg, _t(o), _t(d), RenderConfig())
    # the march is exact (the same samples), the features and MLPs as in
    # test_torch_ml_render's ml_render_test: rgb 1e-2, opacity and depth
    # 1e-4 with the init table; here a table of structure, whose
    # densities reach the bf16 range where one ulp moves alpha: 1e-3
    assert int(got["total_samples"]) == int(ref["total_samples"])
    assert got["iterations"] > 1
    for k, atol in (("rgb", 1e-2), ("opacity", 1e-3), ("depth", 1e-3)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3
    # the dense test layout, once refused: the same rays in (N, 128)
    # blocks (test_torch_dense holds it against JAX)
    dense = render_test(tp, ts, tcfg, _t(o), _t(d),
                        RenderConfig(test_layout="dense"))
    assert int(dense["total_samples"]) > 0 and dense["iterations"] >= 1
    np.testing.assert_allclose(dense["opacity"].numpy(),
                               got["opacity"].numpy(), rtol=0, atol=1e-3)


def _jax_draws(key, grid, cfg, warmup):
    """The draws jax update_density_grid takes from `key` for the single
    field, per cascade, in the port's `draws` format."""
    C, G = cfg.cascades, cfg.grid_size
    M, n_cells = G**3 // 4, G**3
    keys = jax.random.split(key, 2 * C)
    out = []
    for c in range(C):
        dc = {}
        if not warmup:
            k1, k2, k3 = jax.random.split(keys[2 * c + 1], 3)
            total = int((np.asarray(grid)[c] > THRESH).sum())
            dc["uniform"] = jax.random.randint(k1, (M,), 0, n_cells)
            dc["occ_rank"] = jax.random.randint(k2, (M,), 0, max(total, 1))
            dc["fallback"] = jax.random.randint(k3, (M,), 0, n_cells)
        dc["jitter"] = jax.random.uniform(
            keys[2 * c], (n_cells if warmup else 2 * M, 3), minval=-1.0,
            maxval=1.0)
        out.append({a: _t(np.array(v)) for a, v in dc.items()})
    return out


def test_update_density_grid_matches_jax_with_explicit_draws():
    """The single field's grid update (its own density through
    incoherent_impl: brick3_plain), warmup then a later update; the later
    one compared on the cells drawn once or never (a cell drawn twice
    keeps one of its draws, which one is not fixed)."""
    (jcfg, params, state), (tcfg, tp, _) = _field(structured=True)
    state0 = jngp.init_ngp_state(jcfg)
    upd = jax.jit(lambda p, s, k, w: jngp.update_density_grid(
        p, s, jcfg, k, THRESH, w), static_argnums=3)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    warm = upd(params, state0, k1, True)
    got = tngp.update_density_grid(
        tp, state_from_jax(_np(state0), device="cpu"), tcfg, None, THRESH,
        True, draws=_jax_draws(k1, state0["density_grid"], jcfg, True))
    rg, gg = np.asarray(warm["density_grid"]), got["density_grid"].numpy()
    # densities within two bf16 ulps of their exponent (_density_tol)
    assert (np.abs(gg - rg) <= _density_tol(rg)).all()
    assert (gg == rg).mean() > 0.8 and 0.05 < got["occ"].float().mean() < 0.95
    later = upd(params, warm, k2, False)
    ts = state_from_jax(_np(warm), device="cpu")
    draws = _jax_draws(k2, warm["density_grid"], jcfg, False)
    got = tngp.update_density_grid(tp, ts, tcfg, None, THRESH, False,
                                   draws=draws)
    flat = tngp._sample_cells(None, ts["density_grid"][0], 1024, THRESH, 16,
                              draws[0]).numpy()
    times = np.bincount(flat, minlength=4096)
    rg, gg = np.asarray(later["density_grid"])[0], got["density_grid"][0]
    never, once = times == 0, times == 1
    np.testing.assert_array_equal(gg.numpy()[never], rg[never])
    assert (np.abs(gg.numpy()[once] - rg[once]) <= _density_tol(rg[once])
            ).all()
    assert once.sum() > 500 and got["occ"].shape == (1, 16, 16, 16)


def test_ngp_zoo_config_is_the_unshared_mngp():
    for kw in ({}, {"n_experts": 3, "log2_T": 12}, {"shared_encoder": True}):
        got, ref = tzoo.NGPZooConfig(**kw), jzoo.NGPZooConfig(**kw)
        assert dataclasses_equal(got, ref)
    assert not tzoo.NGPZooConfig().shared_encoder
    cfg = tzoo.NGPZooConfig(scale=0.5, grid_size=16, n_levels=4, log2_T=10)
    params = tzoo.init_ngp_zoo(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    assert params["hash_table"].shape == (2, 4, 1024, 2)
    assert not torch.equal(params["hash_table"][0], params["hash_table"][1])
    assert tzoo.init_ngp_zoo_state(cfg, device="cpu")["occ"].shape == (
        2, 1, 16, 16, 16)


def dataclasses_equal(a, b) -> bool:
    return type(a).__name__ == type(b).__name__ and a.__dict__ == b.__dict__


# ------------------------------------------------------- the NeRFSystem

SMALL = dict(grid_size=32, n_levels=4)
RUN = ("Synthetic_NeRF", "TestSphere")


def _args(root, exp, *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", RUN[0], "--scene_name", RUN[1],
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "256", "--num_epochs", "2",
            "--steps_per_epoch", "6", "--hash_impl", "brick3",
            "--num_devices", "1", "--samples_per_ray", "48",
            "--val_chunk", "1024", "--no_save_test", *extra]


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """The port's and the JAX package's single-field NeRFSystem on the
    fixture scene from the same flags, grids cut to 32^3 and 4 levels on
    both sides, the port holding the JAX system's parameters, both a
    sphere occupancy."""
    root = make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "NGPConfig", functools.partial(tt.NGPConfig, **SMALL))
        os.chdir(work)
        try:
            h = get_opts(_args(root, "port"))
            port = tt.NeRFSystem(h, device="cpu")
            port.setup()
            jh = get_opts(_args(root, "jax"))
            jsys = JNeRFSystem(jh)
            jsys.cfg = jngp.NGPConfig(scale=0.5, log2_T=11,
                                      compute_dtype="bfloat16",
                                      hash_impl="brick3", **SMALL)
            jsys.setup()
            occ = _sphere(32)
            jsys.model_state = {**jsys.model_state, "occ": jnp.asarray(occ)}
            tr = port.trainer
            tr.model_state["occ"].copy_(torch.from_numpy(occ))
            tt._copy_into(tr.bundle["model"], _np(jsys.params), "params")
            yield port, jsys, root, work
        finally:
            os.chdir(cwd)


def _batch(jsys, seed, key):
    """A batch of the fixture's store, and the per-ray jitter the JAX
    _loss_fn folds out of `key` (the port takes it in the batch)."""
    rng = np.random.default_rng(seed)
    n_img, n_pix = jsys.data["rays"].shape[:2]
    b = {"img_idxs": rng.integers(0, n_img, 256).astype(np.int32),
         "pix_idxs": rng.integers(0, n_pix, 256).astype(np.int32)}
    k_sample, _ = jax.random.split(key)
    gid = (b["img_idxs"].astype(np.uint32) * np.uint32(n_pix)
           + b["pix_idxs"].astype(np.uint32))
    noise = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_sample, i), ()))(gid)
    tb = {"img_idxs": _t(b["img_idxs"]).long(),
          "pix_idxs": _t(b["pix_idxs"]).long(), "noise": _t(np.array(noise))}
    return b, tb


def test_system_step_matches_the_jax_systems_loss_fn(systems, patched):
    port, jsys, _, _ = systems
    tr = port.trainer
    assert not port.moe and set(tr.bundle) == {"model"}
    assert tr.buckets == tt.BUDGET_BUCKETS
    key = jax.random.PRNGKey(4)
    b, tb = _batch(jsys, 0, key)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda bd: jsys._loss_fn(bd, jsys.model_state, b, jsys.data, key),
        has_aux=True))(jsys.trainable)
    vg = microbatched_value_and_grad(
        lambda bd, bt: tt.loss_fn(bd, tr.model_state, bt, tr.data, tr.cfg,
                                  tr.rcfg, tr.tcfg), 1)
    bundle = {"model": tr.bundle["model"]}
    (loss, aux), grads = vg(bundle, tb)
    # the same march (rm_samples and budget use equal); the loss within
    # 1e-3 relative and each gradient leaf within GRAD_RTOL of its
    # largest entry, as the MoE step in test_torch_ml_train
    assert float(aux["rm_samples"]) == float(jaux["rm_samples"]) > 0
    assert float(aux["budget_util"]) == float(jaux["budget_util"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                               rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    assert len(jleaves) == len(tree_leaves(grads)) == 11
    for (path, r), g in zip(jleaves, tree_leaves(grads)):
        name = jax.tree_util.keystr(path)
        tol = GRAD_RTOL["hash_table"] if "hash_table" in name else \
            GRAD_RTOL_DEFAULT
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max(), name


def test_five_adam_steps_track_the_jax_system(systems, patched):
    port, jsys, _, _ = systems
    tr = port.trainer
    saved = [p.detach().clone() for p in tree_leaves(tr.bundle)]
    # the JAX step donates its parameter and optimizer buffers: copies
    trainable, ost = jax.tree_util.tree_map(
        jnp.copy, (jsys.trainable, jsys.opt_state))
    key = jax.random.PRNGKey(5)
    b, tb = _batch(jsys, 1, key)
    j_losses, t_losses = [], []
    for _ in range(5):
        trainable, ost, jl, _ = jsys.train_step(
            trainable, ost, jsys.model_state, jsys._shard(b), jsys.data, key)
        j_losses.append(float(jl))
        t_losses.append(float(tr.train_step(tb)[0]))
    # five updates at lr 1e-2 on one batch: both losses fall, each within
    # 1% of the other (the bf16 MLPs and the reference's quantized table
    # gradient drift apart), as test_torch_ml_train's five MoE steps
    assert t_losses[-1] < t_losses[0] and j_losses[-1] < j_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-2)
    assert tr.global_step == 5
    with torch.no_grad():
        for p, s in zip(tree_leaves(tr.bundle), saved):
            p.copy_(s)
    tr.optimizer.state.clear()
    tr.global_step = 0


def test_jax_single_field_checkpoint_resumes_with_its_moments(systems,
                                                              tmp_path):
    """A JAX file of the single field: params, optax's Adam state over
    {"model"} after two updates (a schedule: ScaleByScheduleState),
    unstacked grids, no gate_params."""
    port, jsys, root, work = systems
    bundle = jsys._bundle_params()
    ost = jsys.optimizer.init(bundle)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32) * 1e-2, bundle)
        upd, ost = jsys.optimizer.update(g, ost, bundle)
        bundle = optax.apply_updates(bundle, upd)
    path = str(tmp_path / "epoch=0.ckpt")
    jck.save_ckpt(path, {
        "params": bundle["model"], "opt_state": ost,
        "model_state": jsys.model_state, "step": 6,
        "hparams": {"resolved_hash_impl": "brick3"}})
    assert "gate_params" not in jck.load_ckpt(path)
    os.chdir(work)
    system = tt.NeRFSystem(get_opts(_args(root, "from_jax")), device="cpu")
    system.setup()
    system.resume(path)
    assert system.global_step == 6 and system.gate_params is None
    tr = system.trainer
    leaves = tree_leaves(tr.bundle)
    for p, want, m, v in zip(
            leaves, jax.tree_util.tree_leaves(bundle),
            jax.tree_util.tree_leaves(ost[0].mu),
            jax.tree_util.tree_leaves(ost[0].nu)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want))
        st = tr.optimizer.state[p]
        assert float(st["step"]) == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(m))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(v))
    assert system.model_state["density_grid"].shape == (1, 32**3)
    np.testing.assert_array_equal(system.model_state["occ"].numpy(),
                                  np.asarray(jsys.model_state["occ"]))
    system.close()


def test_port_single_field_checkpoint_loads_in_jax(systems):
    """The port's file (no gate_params, unstacked grids) in the JAX
    system's resume: parameters, grids and step restored; the port's
    plain Adam dict is not optax's state, so JAX takes its "opt_state
    structure mismatch" branch (fresh moments)."""
    port, jsys, _, work = systems
    os.chdir(work)
    port.trainer.global_step = 3
    port.save_checkpoint(0)
    port.trainer.global_step = 0
    path = os.path.join(port.ckpt_dir, "epoch=0.ckpt")
    ck = tck.load_ckpt(path)
    assert "gate_params" not in ck and set(ck["opt_state"]) == {
        "count", "mu", "nu"}
    assert set(ck["opt_state"]["mu"]) == {"model"}
    before = jsys.params, jsys.opt_state, jsys.model_state, jsys.global_step
    try:
        jsys.resume(path)
        for a, b in zip(tree_leaves(port.params),
                        jax.tree_util.tree_leaves(jsys.params)):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        assert jsys.global_step == 3
        assert jax.tree_util.tree_structure(jsys.opt_state) == \
            jax.tree_util.tree_structure(jsys.optimizer.init(
                jsys._bundle_params()))
        np.testing.assert_array_equal(
            np.asarray(jsys.model_state["occ"]),
            port.model_state["occ"].numpy())
    finally:
        (jsys.params, jsys.opt_state, jsys.model_state,
         jsys.global_step) = before
        jsys.trainable = jsys._bundle_params()


# ------------------------------------------------- --ckpt_backend orbax

def _payload(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": [torch.rand(64, 8, generator=gen)],
                       "t": torch.rand(3, 5, generator=gen)},
            "opt_state": {"count": np.int32(4),
                          "mu": {"w": [np.ones((2, 2), np.float32)]}},
            "step": 12, "hparams": {"lr": 1e-2, "name": "x"}}


def test_async_writer_writes_the_synchronous_files_bytes(tmp_path):
    w = tck.AsyncCkptWriter()
    payload = _payload()
    w.save(str(tmp_path / "a" / "epoch=0.ckpt"), payload)
    w.wait()
    tck.save_ckpt(str(tmp_path / "b" / "epoch=0.ckpt"), payload)
    a = (tmp_path / "a" / "epoch=0.ckpt").read_bytes()
    assert a == (tmp_path / "b" / "epoch=0.ckpt").read_bytes()
    assert sorted(os.listdir(tmp_path / "a")) == ["epoch=0.ckpt"]


def test_async_writer_copies_first_and_training_does_not_wait(
        systems, monkeypatch):
    """A write held by an event: save_checkpoint returns, two steps run
    while it is held (changing the parameters in place), and the file,
    once released, holds the values of the save; the slim export waits
    for it."""
    port, jsys, root, work = systems
    os.chdir(work)
    held, started = threading.Event(), threading.Event()
    real = tck.save_ckpt

    def slow(path, payload):
        started.set()
        assert held.wait(60)
        real(path, payload)

    monkeypatch.setattr(tck, "save_ckpt", slow)
    system = tt.NeRFSystem(get_opts(_args(root, "orbax", "--ckpt_backend",
                                          "orbax")), device="cpu")
    system.setup()
    want = [p.detach().clone() for p in tree_leaves(system.params)]
    system.save_checkpoint(0)
    assert started.wait(60)
    system.trainer.fit_steps(2)                 # while the write is held
    assert system.global_step == 2
    path = os.path.join(system.ckpt_dir, "epoch=0.ckpt")
    assert not os.path.exists(path)
    moved = [p.detach() for p in tree_leaves(system.params)]
    assert any(not torch.equal(a, b) for a, b in zip(want, moved))
    done = threading.Thread(target=system.export_slim, args=(0,))
    done.start()
    done.join(0.5)
    assert done.is_alive()                     # the export waits
    held.set()
    done.join(60)
    ck = tck.load_ckpt(path)
    assert int(ck["step"]) == 0
    for a, b in zip(want, jax.tree_util.tree_leaves(ck["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    assert os.path.exists(os.path.join(system.ckpt_dir,
                                       "epoch=0_slim.ckpt"))
    system.close()


def test_async_writer_reraises_a_failed_write_at_the_next_wait(
        tmp_path, monkeypatch):
    def fail(path, payload):
        raise OSError("disk full")

    w = tck.AsyncCkptWriter()
    monkeypatch.setattr(tck, "save_ckpt", fail)
    w.save(str(tmp_path / "epoch=0.ckpt"), _payload())     # returns
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.wait()                                   # reported once
    w.save(str(tmp_path / "epoch=1.ckpt"), _payload())
    with pytest.raises(OSError, match="disk full"):
        w.save(str(tmp_path / "epoch=2.ckpt"), _payload())  # waits first
    monkeypatch.undo()
    w.save(str(tmp_path / "epoch=3.ckpt"), _payload())
    w.wait()
    assert os.listdir(tmp_path) == ["epoch=3.ckpt"]


def test_orbax_backend_resume_auto_skips_a_torn_file(systems):
    """--ckpt_backend orbax, --resume auto: a torn epoch=1.ckpt (and the
    temporary file of a killed write) are skipped, epoch 0 resumes; a JAX
    orbax directory still raises, naming orbax."""
    port, jsys, root, work = systems
    os.chdir(work)
    flags = ("--ckpt_backend", "orbax")
    first = tt.NeRFSystem(get_opts(_args(root, "torn", *flags)),
                          device="cpu")
    first.setup()
    first.trainer.fit_steps(6)
    first.save_checkpoint(0)
    first.close()
    d = first.ckpt_dir
    with open(os.path.join(d, "epoch=0.ckpt"), "rb") as f:
        data = f.read()
    with open(os.path.join(d, "epoch=1.ckpt"), "wb") as f:
        f.write(data[:len(data) // 3])
    with open(os.path.join(d, "epoch=1.ckpt.tmp"), "wb") as f:
        f.write(data[:100])
    again = tt.NeRFSystem(get_opts(_args(root, "torn", *flags)),
                          device="cpu")
    again.setup()
    assert again.auto_resume() and again.global_step == 6
    again.close()
    os.makedirs(os.path.join(d, "epoch=5.ckpt"))
    with pytest.raises(NotImplementedError, match="needs orbax"):
        tck.load_ckpt(os.path.join(d, "epoch=5.ckpt"))
    with open(os.path.join(d, "epoch=0.ckpt"), "rb") as f:
        assert pickle.load(f)["step"] == 6
