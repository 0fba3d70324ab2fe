"""--optimize_ext in the port against the JAX package: the differentiable
Rodrigues rotation (values and gradients, at zero too), one MoE training
step's gradient of the pose corrections and the corrections after their
Adam update, with hash_impl 'xla' (the one family whose positions carry
a gradient) and 'brick3' (in interpret mode), the Adam group's
settings, a JAX multi_transform checkpoint resumed by the port's system,
a port checkpoint read by the JAX package (whose resume takes its
"opt_state structure mismatch" branch), and the slim export.

The step harness is tests/test_torch_ml_train.py's (same scene, draws and
tolerance scheme), with the reference trainer's pose refinement
(radnerf_tpu/train/trainer.py::apply_pose_refinement) in its loss.
"""

import functools
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import radnerf_tpu.train.trainer as jt
from radnerf_tpu.data.ray_utils import axisangle_to_R as j_np_axisangle
from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.metrics import psnr as j_psnr
from radnerf_tpu.parallel.step import (
    microbatched_value_and_grad as j_microbatched_vg,
)
from radnerf_tpu.render.ml_render import ml_render_train as j_ml_render_train
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu.utils import ckpt as jck
from radnerf_tpu_torch import train_ml
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.data.ray_utils import axisangle_to_R
from radnerf_tpu_torch.models.mngp import MNGPConfig
from radnerf_tpu_torch.opt import get_opts
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves,
)
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.utils.ckpt import load_ckpt

from .fixtures import make_nsvf_dataset
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    CFG_KW, GRAD_RTOL, GRAD_RTOL_DEFAULT, LOSS_W, N_IMG, RENDER_KW, TCFG,
    _batch, _np, _setup, _store, _t_batch, _t_data, patched,
)

torch.set_num_threads(1)


def _axisangles(seed=0):
    """(N, 3) axis-angle vectors: zeros, below and above the theta^2 =
    1e-8 switch, and ordinary rotations."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(8, 3))
    v[:2] = 0.0
    v[2:4] *= 1e-5 / np.linalg.norm(v[2:4], axis=1, keepdims=True)
    v[4:6] *= 3e-4 / np.linalg.norm(v[4:6], axis=1, keepdims=True)
    return v.astype(np.float32)


def test_axisangle_to_R_matches_jax_with_finite_gradients_at_zero():
    v = _axisangles()
    got = tt.torch_axisangle_to_R(torch.from_numpy(v))
    want = jt.jnp_axisangle_to_R(jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-7)
    # the gradient of a random linear read-out of R
    w = np.random.default_rng(1).normal(size=(8, 3, 3)).astype(np.float32)
    tv = torch.from_numpy(v).requires_grad_(True)
    (tt.torch_axisangle_to_R(tv) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jt.jnp_axisangle_to_R(x) * w))(
        jnp.asarray(v))
    assert torch.isfinite(tv.grad).all()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=2e-6)
    # the host copy of the reference's Rodrigues (data/ray_utils.py)
    np.testing.assert_array_equal(axisangle_to_R(v), j_np_axisangle(v))
    np.testing.assert_array_equal(axisangle_to_R(v[5]), j_np_axisangle(v[5]))


def _ext(kind, seed=7):
    """Pose corrections: "zero" (the init), "shift" (dT only: the refined
    poses are exact on both sides) or "random" (dR and dT)."""
    rng = np.random.default_rng(seed)
    ext = {k: (rng.normal(size=(N_IMG, 3)) * 0.02).astype(np.float32)
           for k in ("dR", "dT")}
    if kind in ("zero", "shift"):
        ext["dR"][:] = 0.0
    if kind == "zero":
        ext["dT"][:] = 0.0
    return ext


def _j_loss_ext(jcfg, rcfg, state, data):
    """test_torch_ml_train's reference loss with the trainer's pose
    refinement: the bundle's "ext" refines the batch's poses, which cast
    the rays and the gate's image direction."""
    data = {k: jnp.asarray(v) for k, v in data.items()}

    def loss3(bundle, batch, key):
        poses = jt.apply_pose_refinement(
            data["poses"][batch["img_idxs"]], bundle["ext"],
            batch["img_idxs"])
        rays_o, rays_d = jt.jnp_get_rays(
            data["directions"][batch["pix_idxs"]], poses)
        imgs_d = jt.jnp_get_rays(jnp.broadcast_to(
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


def j_optimizer_ext(tcfg, bundle):
    """The reference's multi_transform ({"net": its scheduled Adam, "ext":
    optax.adam(1e-8)}): NeRFSystem.configure_optimizers on a stand-in."""
    system = SimpleNamespace(
        h=SimpleNamespace(lr=tcfg.lr, num_epochs=tcfg.num_epochs),
        train_dataset=SimpleNamespace(STEPS_PER_EPOCH=tcfg.steps_per_epoch),
        ext_params=bundle["ext"], _bundle_params=lambda: bundle)
    jt.NeRFSystem.configure_optimizers(system)
    return system.optimizer


# 'xla' is held with unrotated corrections: a rotation refined in another
# summation order (XLA's batched matmul and its fused multiply-adds
# against torch's) moves a ray by an ulp, which now and then moves a
# sample across a fine-level cell, where the position gradient of a
# random table jumps (2% of dT's largest entry from a handful of samples)
# 'exp': scale 1 with the trainer's growing steps (exp_step_factor 1/256),
# where the march's deltas depend on t: the reference stops their
# gradient, and so must the port
@pytest.mark.parametrize("impl,ext_kind,lattice", [
    ("xla", "zero", "const"), ("xla", "shift", "const"),
    ("brick3", "zero", "const"), ("brick3", "random", "const"),
    ("brick3", "random", "exp")])
def test_optimize_ext_step_matches_jax(patched, impl, ext_kind, lattice):
    """One microbatched step with pose corrections on both sides: the loss,
    every gradient leaf (dR and dT among them) within the step tests'
    tolerances of its largest entry, and the corrections after one Adam
    update (the port's Trainer against optax's multi_transform)."""
    cfg_kw = {**CFG_KW, "hash_impl": impl}
    render_kw = dict(RENDER_KW)
    if lattice == "exp":
        cfg_kw["scale"] = 1.0
        render_kw["exp_step_factor"] = 1 / 256
    jcfg, jbundle, jstate = _setup(cfg_kw)
    # the same occupancy in every cascade of the scale
    jstate["occ"] = jnp.repeat(jstate["occ"][:, :1], jcfg.cascades, axis=1)
    ext = _ext(ext_kind)
    jbundle = {**jbundle, "ext": jax.tree_util.tree_map(jnp.asarray, ext)}
    data = _store()
    batch = _batch(0)
    (jl, _), jg = jax.jit(j_microbatched_vg(
        _j_loss_ext(jcfg, JRender(**render_kw), jstate, data), 2))(
        jbundle, batch, jax.random.PRNGKey(5))

    cfg = MNGPConfig(**cfg_kw)
    tp, tg = params_from_jax(_np(jbundle["model"]), _np(jbundle["gate"]),
                             device="cpu")
    text = {k: torch.from_numpy(v.copy()) for k, v in ext.items()}
    bundle = {"model": tp, "gate": tg, "ext": text}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    ts = state_from_jax(_np(jstate), device="cpu")
    tdata = _t_data(data)
    tdata["mean_dir"] = tdata["directions"].mean(0)
    rcfg = tt.RenderConfig(**render_kw)
    (loss, _), grads = microbatched_value_and_grad(
        lambda b, bt: tt.loss_fn(b, ts, bt, tdata, cfg, rcfg, TCFG), 2)(
        bundle, _t_batch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jg))
    tleaves = tree_leaves(grads)
    assert len(jleaves) == len(tleaves) == 2 + 1 + 2 * 2 + 2 * 3 + 2 * 5
    for (path, ref), got in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        got = got.numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        rtol = next((v for k, v in GRAD_RTOL.items() if k in name),
                    GRAD_RTOL_DEFAULT)
        if impl == "xla" and "hash_table" in name:
            # the reference's xla table gradient is its autodiff
            # scatter-add summed in bf16; the port's is the exact f32 one
            # (ROADMAP.md section 3)
            rtol = 0.1
        assert np.abs(got - ref).max() <= rtol * scale, (
            name, np.abs(got - ref).max() / scale)

    # one Adam update: the Trainer's second group against optax's "ext"
    opt = j_optimizer_ext(TCFG, jbundle)
    upd, _ = opt.update(jg, opt.init(jbundle), jbundle)
    jnew = optax.apply_updates(jbundle, upd)["ext"]
    tp, tg = params_from_jax(_np(jbundle["model"]), _np(jbundle["gate"]),
                             device="cpu")
    trainer = tt.Trainer(cfg, TCFG, tp, tg, ts, _t_data(data),
                         torch.Generator(),
                         {k: torch.from_numpy(v.copy())
                          for k, v in ext.items()})
    group = trainer.optimizer.param_groups[1]
    assert (group["lr"], group["eps"], group["betas"]) == (1e-8, 1e-8,
                                                           (0.9, 0.999))
    assert trainer.optimizer.param_groups[0]["eps"] == 1e-15
    trainer.train_step(_t_batch(batch))
    for k in ("dR", "dT"):
        got = trainer.bundle["ext"][k].detach().numpy()
        g = np.asarray(jg["ext"][k])
        # Adam's first update moves each entry by lr * g / (|g| + eps):
        # the same where the two gradients' entries are not near zero
        big = np.abs(g) > 0.05 * np.abs(g).max()
        assert big.any()
        np.testing.assert_allclose(got[big], np.asarray(jnew[k])[big],
                                   rtol=2**-22, atol=1e-12)
        # and Adam's step on the port's own gradient, to float32 rounding
        tg_k = grads["ext"][k].numpy().astype(np.float64)
        want = ext[k] - 1e-8 * tg_k / (np.abs(tg_k) + 1e-8)
        np.testing.assert_allclose(got, want, rtol=2**-23, atol=1e-14)


def test_positions_carry_the_gradient_with_xla_only():
    """The encode's position gradient: 'xla' autodiffs its plain gather,
    so positions get one (as jax.grad of the reference's hashgrid_encode
    gives); every family with a table-gradient backward gives none, as
    the reference's custom_vjps return zeros."""
    from radnerf_tpu.ops.hashgrid import HashGridConfig as JHCfg
    from radnerf_tpu.ops.hashgrid import encode_dispatch as j_encode
    from radnerf_tpu_torch.ops.hashgrid import (
        HashGridConfig, encode_dispatch,
    )

    hc = HashGridConfig(n_levels=4, log2_table_size=10)
    jhc = JHCfg(n_levels=4, log2_table_size=10)
    rng = np.random.default_rng(0)
    table = (rng.random((4, 1 << 10, 2)) * 2 - 1).astype(np.float32)
    # positions on a 2^-16 lattice, away from cell boundaries' FMA cases
    x = (np.round(rng.random((64, 3)) * 2**16) / 2**16).astype(np.float32)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(j_encode(
        jnp.asarray(table), p, jhc, jnp.bfloat16, "xla").astype(
        jnp.float32) * w), )(jnp.asarray(x))
    for impl in ("xla", "window", "dedup", "brick3"):
        tx = torch.from_numpy(x).requires_grad_(True)
        out = encode_dispatch(torch.from_numpy(table).requires_grad_(True),
                              tx, hc, torch.bfloat16, impl)
        (out.float() * torch.from_numpy(w)).sum().backward()
        if impl == "xla":
            scale = np.abs(np.asarray(jgrad)).max()
            assert scale > 0
            assert np.abs(tx.grad.numpy() - np.asarray(jgrad)).max() \
                <= 2e-2 * scale
        else:
            assert tx.grad is None or not tx.grad.any(), impl


# ---------------------------------------------------------------- system
SMALL = dict(grid_size=32, n_levels=4)


def _args(root, exp, *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", "Synthetic_NeRF", "--scene_name", "TestSphere",
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "256", "--num_epochs", "2",
            "--steps_per_epoch", "3", "--model_zoo_size", "2",
            "--hash_impl", "brick3", "--val_chunk", "1024", "--no_save_test",
            *extra]


@pytest.fixture(scope="module")
def ext_run(tmp_path_factory):
    """train_ml.main with --optimize_ext on the NSVF fixture, 2 x 3
    steps, in a working directory of its own."""
    root = make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "MNGPConfig", functools.partial(tt.MNGPConfig,
                                                       **SMALL))
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        os.chdir(work)
        try:
            system = train_ml.main(_args(root, "ext", "--optimize_ext"),
                                   device="cpu")
            yield SimpleNamespace(system=system, root=root, work=work)
        finally:
            os.chdir(cwd)


def _ckpt(run, name):
    return os.path.join(run.work, "ckpts", "Synthetic_NeRF", "TestSphere",
                        "ext", name)


def test_optimize_ext_trains_and_checkpoints_the_corrections(ext_run):
    system = ext_run.system
    ext = system.ext_params
    assert set(ext) == {"dR", "dT"}
    for v in ext.values():
        assert v.shape == (len(system.train_dataset.poses), 3)
        assert torch.isfinite(v).all() and v.abs().max() > 0
        # six Adam steps at 1e-8 move an entry by at most ~6e-8
        assert v.abs().max() <= 7e-8
    full = load_ckpt(_ckpt(ext_run, "epoch=1.ckpt"))
    for k in ("dR", "dT"):
        np.testing.assert_array_equal(full["ext_params"][k],
                                      ext[k].detach().numpy())
    opt = full["opt_state"]
    assert set(opt) == {"net", "ext"}
    assert int(opt["net"]["count"]) == int(opt["ext"]["count"]) == 6
    assert set(opt["net"]["mu"]) == {"model", "gate"}
    assert set(opt["ext"]["mu"]) == {"ext"}


def test_port_ext_checkpoint_resumes_in_the_port(ext_run, tmp_path):
    path = _ckpt(ext_run, "epoch=0.ckpt")
    os.chdir(ext_run.work)
    h = get_opts(_args(ext_run.root, "resume", "--optimize_ext"))
    h.moe_training = True
    system = tt.NeRFSystem(h, device="cpu")
    system.setup()
    system.resume(path)
    ck = load_ckpt(path)
    for k in ("dR", "dT"):
        np.testing.assert_array_equal(system.ext_params[k].detach().numpy(),
                                      ck["ext_params"][k])
        p = system.ext_params[k]
        st = system.trainer.optimizer.state[p]
        assert float(st["step"]) == 3
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      ck["opt_state"]["ext"]["mu"]["ext"][k])
    system.close()


def test_port_ext_checkpoint_in_jax_takes_the_mismatch_branch(ext_run):
    """The JAX package reads the port's file (parameters, ext_params), and
    its resume finds the port's plain Adam dicts unlike optax's
    multi_transform state: it takes its "opt_state structure mismatch"
    branch and starts with fresh moments, keeping parameters and poses."""
    ck = jck.load_ckpt(_ckpt(ext_run, "epoch=1.ckpt"))
    bundle = {"model": ck["params"], "gate": ck["gate_params"],
              "ext": ck["ext_params"]}
    live = j_optimizer_ext(tt.TrainConfig(), bundle).init(
        jax.tree_util.tree_map(jnp.asarray, bundle))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(jnp.asarray, ck["opt_state"])) != \
        jax.tree_util.tree_structure(live)
    for k in ("dR", "dT"):
        np.testing.assert_array_equal(
            ck["ext_params"][k], ext_run.system.ext_params[k].detach().numpy())


def test_jax_ext_checkpoint_resumes_in_the_port(ext_run, tmp_path):
    """A JAX --optimize_ext checkpoint: optax's multi_transform state
    (PartitionState of MaskedStates, MaskedNode leaves) after one update,
    with its own counts; the port resumes both Adam groups' moments."""
    ck = load_ckpt(_ckpt(ext_run, "epoch=1.ckpt"))
    rng = np.random.default_rng(0)
    bundle = jax.tree_util.tree_map(jnp.asarray, {
        "model": ck["params"], "gate": ck["gate_params"],
        "ext": {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
                for k, v in ck["ext_params"].items()}})
    opt = j_optimizer_ext(tt.TrainConfig(), bundle)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32) * 1e-2,
        bundle)
    state = opt.init(bundle)
    for _ in range(2):
        upd, state = opt.update(grads, state, bundle)
    path = str(tmp_path / "epoch=0.ckpt")
    jck.save_ckpt(path, {
        "params": bundle["model"], "gate_params": bundle["gate"],
        "ext_params": bundle["ext"], "opt_state": state,
        "model_state": ck["model_state"], "step": 2,
        "hparams": {"resolved_hash_impl": "brick3"}})
    os.chdir(ext_run.work)
    h = get_opts(_args(ext_run.root, "from_jax", "--optimize_ext"))
    h.moe_training = True
    system = tt.NeRFSystem(h, device="cpu")
    system.setup()
    system.resume(path)
    inner = state.inner_states
    net_mu = jax.tree_util.tree_leaves(
        {k: v for k, v in inner["net"].inner_state[0].mu.items()
         if k != "ext"})
    ext_mu = jax.tree_util.tree_leaves(inner["ext"].inner_state[0].mu["ext"])
    ext_nu = jax.tree_util.tree_leaves(inner["ext"].inner_state[0].nu["ext"])
    tr = system.trainer
    net = tree_leaves({"model": tr.bundle["model"], "gate": tr.bundle["gate"]})
    assert len(net) == len(net_mu)
    for p, m in zip(net, net_mu):
        np.testing.assert_array_equal(tr.optimizer.state[p]["exp_avg"].numpy(),
                                      np.asarray(m))
        assert float(tr.optimizer.state[p]["step"]) == 2
    for p, m, v, b in zip(tree_leaves(tr.bundle["ext"]), ext_mu, ext_nu,
                          jax.tree_util.tree_leaves(bundle["ext"])):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(b))
        np.testing.assert_array_equal(tr.optimizer.state[p]["exp_avg"].numpy(),
                                      np.asarray(m))
        np.testing.assert_array_equal(
            tr.optimizer.state[p]["exp_avg_sq"].numpy(), np.asarray(v))
    system.close()


def test_slim_export_equals_jax(ext_run):
    """export_slim passes save_poses as the reference does; its slim_ckpt
    keeps "pose_params", which no checkpoint holds (poses are saved as
    "ext_params"), so neither package's slim file carries the poses."""
    full = _ckpt(ext_run, "epoch=1.ckpt")
    port = load_ckpt(_ckpt(ext_run, "epoch=1_slim.ckpt"))
    ref = jck.slim_ckpt(full, save_poses=True)
    assert set(port) == set(ref) == {"params", "gate_params", "step",
                                     "hparams"}
    for a, b in zip(jax.tree_util.tree_leaves(port["params"]),
                    jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_array_equal(a, b)
    assert int(port["step"]) == int(ref["step"]) == 6
    assert port["hparams"]["optimize_ext"] and ref["hparams"]["optimize_ext"]
