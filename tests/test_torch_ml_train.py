"""PyTorch port vs the JAX package, the slice as a whole: one Rad-NeRF MoE
training step (ray gate, one union march, one shared hash encode,
per-expert MLPs and flat compositing, nerf_loss with the opacity, cv and
depth-mutual terms, microbatched gradient, Adam at the cosine learning
rate), at `__graft_entry__._tiny_setup`'s size with hash_impl pinned on
both sides (brick3, and each other family: dedup, slab, brick, pallas,
and float32 compute) and the flat layout with union sampling.

The JAX side runs its Pallas kernels in interpret mode; its backwards are
reached through `encode_dispatch`, so the family entry points are patched
to interpret=True. The reference's loss is its trainer's (trainer.py
`build_steps`) with the per-ray start jitter handed in: the port draws it
from a torch.Generator, so both take the same numpy draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import radnerf_tpu.ops.hashgrid_brick as jbr
import radnerf_tpu.ops.hashgrid_brick3 as jb3
import radnerf_tpu.ops.hashgrid_dedup as jdd
import radnerf_tpu.ops.hashgrid_pallas as jhp
import radnerf_tpu.ops.hashgrid_slab as jsl
import radnerf_tpu.ops.hashgrid_window as jhw
from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.metrics import psnr as j_psnr
from radnerf_tpu.models.gates import init_ray_gate as j_init_gate
from radnerf_tpu.models.mngp import MNGPConfig as JCfg
from radnerf_tpu.models.mngp import init_mngp as j_init_mngp
from radnerf_tpu.models.mngp import init_mngp_state as j_init_state
from radnerf_tpu.parallel.step import (
    microbatched_value_and_grad as j_microbatched_vg,
)
from radnerf_tpu.render.ml_render import ml_render_train as j_ml_render_train
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu.train.trainer import jnp_get_rays
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.models.mngp import MNGPConfig
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves, tree_paths,
)
from radnerf_tpu_torch.render.ml_render import ml_render_train
from radnerf_tpu_torch.render.render import RenderConfig
from radnerf_tpu_torch.train import trainer as tt

from .test_torch_train_ops import j_optimizer

torch.set_num_threads(1)

CFG_KW = dict(scale=0.5, grid_size=16, n_levels=4, log2_T=10, n_experts=2,
              compute_dtype="bfloat16", hash_impl="brick3")
# the trainer's render settings at this config (adaptive budget: the union
# budget factor is 1), with _tiny_setup's per-ray cap
RENDER_KW = dict(samples_per_ray=32, layout="flat", budget_per_ray=64,
                 union_budget_factor=1.0)
TCFG = tt.TrainConfig(batch_size=128, microbatch=2, samples_per_ray=32,
                      steps_per_epoch=2, num_epochs=4)
LOSS_W = dict(lambda_opacity=1e-3, lambda_cv_importance=1e-2,
              lambda_depth_mutual=5e-3)
N_IMG, N_PIX = 2, 256


@pytest.fixture
def patched(monkeypatch):
    for mod, name in ((jb3, "hashgrid_encode_brick3"),
                      (jhw, "hashgrid_encode_window"),
                      (jdd, "hashgrid_encode_dedup"),
                      (jhp, "hashgrid_encode_fused"),
                      (jsl, "hashgrid_encode_slab"),
                      (jbr, "hashgrid_encode_brick")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _store(seed=0):
    """Two cameras at radius 1.2 looking at the origin, 16x16 pixels each,
    and a smooth target colour per pixel."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid((np.arange(16) + 0.5) / 16 - 0.5,
                       (np.arange(16) + 0.5) / 16 - 0.5)
    dirs = np.stack([u, v, np.full_like(u, 1.2)], -1).reshape(-1, 3)
    poses = []
    for eye in ([0.0, -1.2, 0.25], [1.1, 0.3, -0.4]):
        eye = np.array(eye)
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses.append(np.concatenate(
            [np.stack([right, down, fwd], axis=1), eye[:, None]], axis=1))
    rays = 0.5 + 0.4 * np.sin(np.arange(N_IMG * N_PIX * 3).reshape(
        N_IMG, N_PIX, 3) * 0.37 + rng.uniform(0, 6, 3))
    return {"rays": rays.astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "directions": dirs.astype(np.float32)}


def _batch(seed):
    rng = np.random.default_rng(100 + seed)
    return {"img_idxs": rng.integers(0, N_IMG, 128).astype(np.int32),
            "pix_idxs": rng.integers(0, N_PIX, 128).astype(np.int32),
            "noise": rng.random(128).astype(np.float32)}


def _setup(cfg_kw=CFG_KW):
    jcfg = JCfg(**cfg_kw)
    params = j_init_mngp(jax.random.PRNGKey(0), jcfg)
    gate = j_init_gate(jax.random.PRNGKey(1), jcfg.n_experts)
    # occupied: a 0.3-radius sphere for expert 0, its +x half for expert 1
    lin = (np.arange(16) + 0.5) / 16 * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3
    state = {**j_init_state(jcfg),
             "occ": jnp.asarray(np.stack([sphere, sphere & (xx > 0)])[:, None])}
    return jcfg, {"model": params, "gate": gate}, state


def _j_loss(jcfg, rcfg, state, data):
    """trainer.py build_steps' loss_fn, with the jitter an input."""
    data = {k: jnp.asarray(v) for k, v in data.items()}

    def loss3(bundle, batch, key):
        poses = data["poses"][batch["img_idxs"]]
        rays_o, rays_d = jnp_get_rays(
            data["directions"][batch["pix_idxs"]], poses)
        imgs_d = jnp_get_rays(jnp.broadcast_to(
            data["directions"].mean(0), (poses.shape[0], 3)), poses)[1]
        target = {"rgb": data["rays"][batch["img_idxs"],
                                      batch["pix_idxs"]][:, :3]}
        out = j_ml_render_train(
            bundle["model"], state, jcfg, bundle["gate"], rays_o, rays_d,
            imgs_d, key, rcfg, "ray", noise=batch["noise"])
        ld = j_nerf_loss(out, target, **LOSS_W)
        return j_total_loss(ld), {
            "psnr": j_psnr(out["rgb"], target["rgb"]),
            "rm_samples": out["rm_samples"].astype(jnp.float32),
            "budget_util": out["budget_util"].astype(jnp.float32)}
    return loss3


def _t_data(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _t_batch(b):
    return {"img_idxs": torch.from_numpy(b["img_idxs"]).long(),
            "pix_idxs": torch.from_numpy(b["pix_idxs"]).long(),
            "noise": torch.from_numpy(b["noise"])}


# each leaf's gradient, relative to its largest entry: the MLPs run in
# bf16 on both sides and round in different places now and then (one bf16
# ulp, 2^-8, carried through later layers); the table gradient differs
# more: the reference's default backward quantizes fractions to 10 bits
# and g to bf16 (test_torch_hashgrid_brick3_grad), the port's is exact
GRAD_RTOL = {"hash_table": 4e-2}
GRAD_RTOL_DEFAULT = 2e-2


def _one_step_vs_jax(cfg_kw, loss_rtol, grad_rtol):
    """One microbatched step on both sides from the same parameters, state
    and draws: loss, sample counts and every gradient leaf, each leaf
    within grad_rtol(name) of its largest entry."""
    jcfg, jbundle, jstate = _setup(cfg_kw)
    rcfg_j, rcfg_t = JRender(**RENDER_KW), RenderConfig(**RENDER_KW)
    data = _store()
    batch = _batch(0)
    (jl, jaux), jg = jax.jit(j_microbatched_vg(
        _j_loss(jcfg, rcfg_j, jstate, data), 2))(
        jbundle, batch, jax.random.PRNGKey(5))

    tcfg = MNGPConfig(**cfg_kw)
    tp, tg = params_from_jax(_np(jbundle["model"]), _np(jbundle["gate"]),
                             device="cpu")
    bundle = {"model": tp, "gate": tg}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    ts = state_from_jax(_np(jstate), device="cpu")
    tdata = _t_data(data)
    tdata["mean_dir"] = tdata["directions"].mean(0)
    vg = microbatched_value_and_grad(
        lambda b, bt: tt.loss_fn(b, ts, bt, tdata, tcfg, rcfg_t, TCFG), 2)
    (loss, aux), grads = vg(bundle, _t_batch(batch))

    np.testing.assert_allclose(float(loss), float(jl), rtol=loss_rtol)
    assert float(aux["rm_samples"]) == float(jaux["rm_samples"])
    assert float(aux["budget_util"]) == float(jaux["budget_util"])
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                               rtol=loss_rtol)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    tleaves = tree_leaves(grads)
    assert len(jleaves) == len(tleaves) == 1 + 2 * 2 + 2 * 3 + 2 * 5
    for (path, ref), got in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        got = got.numpy()
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(got - ref).max() <= grad_rtol(name) * scale, (
            name, np.abs(got - ref).max() / scale)


def test_one_step_loss_and_every_gradient_leaf_match_jax(patched):
    # the march is exact, the encode within a bf16 ulp; the loss carries
    # the bf16 MLPs' rounding differences (rgb to ~1e-2 per value, summed
    # in a mean of squares)
    _one_step_vs_jax(CFG_KW, 1e-3, lambda name: next(
        (v for k, v in GRAD_RTOL.items() if k in name), GRAD_RTOL_DEFAULT))


# the other hash families (and float32 compute, where brick3 falls back to
# 'dedup' on both sides); each family's table gradient is the port's exact
# f32 one against the reference's f16-packed (window, slab, brick) or
# exact (pallas) one
FAMILIES = [dict(hash_impl="dedup"), dict(hash_impl="slab"),
            dict(hash_impl="brick"), dict(hash_impl="pallas"),
            dict(compute_dtype="float32", hash_impl="brick3")]


@pytest.mark.parametrize("family", FAMILIES,
                         ids=lambda f: "-".join(f.values()))
def test_one_step_per_hash_family_matches_jax(patched, family):
    cfg_kw = {**CFG_KW, **family}
    if cfg_kw["compute_dtype"] == "float32":
        # float32 MLPs and encode on both sides: sums in other orders, and
        # XLA's partial fused multiply-adds of the hash coordinates (a few
        # f32 ulps per feature). The first geo layer's weight gradient is
        # a sum over ~4k samples of features near the +-1e-4 table init
        # that mostly cancels (1.6e-3 of its largest entry here): 5e-3 for
        # every leaf
        _one_step_vs_jax(cfg_kw, 1e-5, lambda name: 5e-3)
    else:
        # as the brick3 step above
        _one_step_vs_jax(cfg_kw, 1e-3, lambda name: next(
            (v for k, v in GRAD_RTOL.items() if k in name),
            GRAD_RTOL_DEFAULT))


def test_five_adam_steps_track_the_jax_loss(patched):
    jcfg, jbundle, jstate = _setup()
    rcfg_j = JRender(**RENDER_KW)
    data = _store()
    _, opt = j_optimizer(TCFG)
    vg = jax.jit(j_microbatched_vg(_j_loss(jcfg, rcfg_j, jstate, data), 2))
    ost = opt.init(jbundle)
    j_losses = []
    for s in range(5):
        (jl, _), g = vg(jbundle, _batch(0), jax.random.PRNGKey(5))
        up, ost = opt.update(g, ost, jbundle)
        jbundle = optax.apply_updates(jbundle, up)
        j_losses.append(float(jl))

    jcfg, jb0, _ = _setup()
    tp, tg = params_from_jax(_np(jb0["model"]), _np(jb0["gate"]),
                             device="cpu")
    trainer = tt.Trainer(MNGPConfig(**CFG_KW), TCFG, tp, tg,
                         state_from_jax(_np(jstate), device="cpu"),
                         _t_data(data), torch.Generator())
    assert trainer.rcfg == RenderConfig(**RENDER_KW)
    t_losses = [float(trainer.train_step(_t_batch(_batch(0)))[0])
                for s in range(5)]
    # five updates on one batch: the losses fall on both sides, and each
    # stays within what the bf16 MLPs and the quantized reference table
    # gradient let drift: 1% of the loss after five updates at lr 1e-2
    assert t_losses[-1] < t_losses[0] and j_losses[-1] < j_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-2)
    assert trainer.global_step == 5


def test_unported_training_paths_raise():
    tcfg = MNGPConfig(**CFG_KW)
    o = torch.zeros(8, 3)
    d = torch.nn.functional.normalize(torch.ones(8, 3), dim=1)
    for rcfg in (RenderConfig(layout="dense"),
                 RenderConfig(layout="flat", union_sampling=False)):
        with pytest.raises(NotImplementedError):
            ml_render_train({}, {}, tcfg, {}, o, d, d, rcfg)


def test_tree_paths_name_the_leaves_in_jax_order():
    """tree_paths names each leaf of tree_leaves (the order in which the
    card-vs-CPU step check reports its gradient leaves) by the same path
    as JAX's tree_leaves_with_path on the same structure."""
    shapes = {"model": {"hash_table": (4,), "geo": {"w": [(1,), (2,)],
                                                   "b": [(3,), (5,)]}},
              "gate": {"encoder": {"w": [(6,)], "b": [(7,)]}}}

    def build(t, leaf):
        if isinstance(t, dict):
            return {k: build(v, leaf) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, leaf) for v in t]
        return leaf(t)

    jtree = build(shapes, np.zeros)
    ttree = build(shapes, torch.zeros)
    jpaths = [
        "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                 for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(jtree)]
    paths = tree_paths(ttree)
    assert paths == jpaths
    assert paths[0] == "gate/encoder/b/0"
    assert [tuple(t.shape) for t in tree_leaves(ttree)] == [
        np.shape(a) for a in jax.tree_util.tree_leaves(jtree)]
