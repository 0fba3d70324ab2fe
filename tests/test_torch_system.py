"""The port's entry points end to end on the CPU, against the JAX package
where the two compute the same thing: `radnerf_tpu_torch.train_ml.main`
trains the NSVF fixture scene (T=2^11, batch 256, 6 steps an epoch, 2
epochs) and writes checkpoints, a slim export, validation images,
metrics and a profiler trace; validation's PSNR and SSIM are the JAX
metrics of the same renders; --resume auto skips a torn checkpoint; the
learning rate is the JAX closure's; --no-adaptive_budget, --random_bg,
--host_sampling (no effect, as in the reference), the oracle, the train.py
twin (the MoE with --moe_training, the single NGP field without), the
single field trained, validated, checkpointed and rendered by the oracle,
--ckpt_backend orbax training, checkpointing and resuming, the layout
and data-parallel flags, and a JAX checkpoint resumed by the system.

The system builds MNGPConfig (NGPConfig for the single field) from the
flags; the density grid (128^3 in the reference, no flag) is cut to 32^3
and the levels to 4 here, so that the CPU run stays short.
"""

import functools
import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu.metrics import psnr as j_psnr
from radnerf_tpu.metrics import ssim as j_ssim
from radnerf_tpu.opt import get_parser as j_get_parser
from radnerf_tpu.train.trainer import NeRFSystem as JNeRFSystem
from radnerf_tpu.utils import ckpt as jck
from radnerf_tpu_torch import oracle, train_ml
from radnerf_tpu_torch.opt import get_opts, get_parser
from radnerf_tpu_torch.parallel import mesh as tmesh
from radnerf_tpu_torch.parallel.step import tree_leaves
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.utils.ckpt import load_ckpt

from .fixtures import make_nsvf_dataset

SMALL = dict(grid_size=32, n_levels=4)
RUN = ("Synthetic_NeRF", "TestSphere")


def args(root, exp="t", *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", RUN[0], "--scene_name", RUN[1],
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "256", "--num_epochs", "2",
            "--steps_per_epoch", "6", "--model_zoo_size", "2",
            "--hash_impl", "brick3", "--val_chunk", "1024", *extra]


def system_for(root, exp, *extra, moe=True):
    h = get_opts(args(root, exp, *extra))
    h.moe_training = moe
    return tt.NeRFSystem(h, device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """train_ml.main on the fixture scene, in a working directory of its
    own (logs/, ckpts/, results/ are relative to it)."""
    root = make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "MNGPConfig", functools.partial(tt.MNGPConfig,
                                                       **SMALL))
        mp.setattr(tt, "NGPConfig", functools.partial(tt.NGPConfig,
                                                      **SMALL))
        # as on a machine without tensorboard: metrics.jsonl only
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        os.chdir(work)
        try:
            system = train_ml.main(
                args(root, "t", "--profile_steps", "2"), device="cpu",
                on_step=lambda step, loss, aux: steps.append(step))
            yield types.SimpleNamespace(system=system, root=root,
                                        work=work, steps=steps, mp=mp)
        finally:
            os.chdir(cwd)


def _path(run, kind, exp, name):
    return os.path.join(run.work, kind, *RUN, exp, name)


def _metrics(run, exp="t"):
    with open(_path(run, "logs", exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_ml_writes_checkpoints_images_metrics_and_a_trace(run):
    assert run.steps == list(range(12)) and run.system.global_step == 12
    for name in ("epoch=0.ckpt", "epoch=1.ckpt", "epoch=1_slim.ckpt"):
        assert os.path.exists(_path(run, "ckpts", "t", name)), name
    slim = load_ckpt(_path(run, "ckpts", "t", "epoch=1_slim.ckpt"))
    assert set(slim) == {"params", "gate_params", "step", "hparams"}
    full = load_ckpt(_path(run, "ckpts", "t", "epoch=1.ckpt"))
    assert int(full["step"]) == 12 and int(full["opt_state"]["count"]) == 12
    assert full["hparams"]["resolved_hash_impl"] == "brick3"
    # validation once, at the last epoch (min(2, 10) = 2): 2 test views,
    # each a prediction and a turbo depth image
    pngs = sorted(os.listdir(os.path.join(run.work, "results", *RUN, "t")))
    assert pngs == ["000epoch1.png", "000epoch1_d.png", "001epoch1.png",
                    "001epoch1_d.png"]
    tags = {(m["tag"], m["step"]) for m in _metrics(run)}
    assert {("train/loss", 0), ("train/psnr", 0), ("lr", 0),
            ("train/rays_per_s", 0), ("test/psnr", 12),
            ("test/ssim", 12)} <= tags
    with open(_path(run, "logs", "t", "trace/trace.json")) as f:
        assert json.load(f)["traceEvents"]
    with open(_path(run, "logs", "t", "log.txt")) as f:
        assert "images read by native" in f.read()


def test_validate_metrics_are_the_jax_metrics_of_the_renders(run):
    system = run.system
    ds = system.test_dataset
    w, h = ds.img_wh
    psnrs, ssims = [], []
    for i, pose in enumerate(ds.poses):
        out = system.render_view(torch.from_numpy(pose),
                                 torch.from_numpy(ds.directions))
        pred = out["rgb"].numpy().reshape(h, w, 3)
        gt = ds.rays[i][:, :3].reshape(h, w, 3)
        psnrs.append(float(j_psnr(pred, gt)))
        ssims.append(float(j_ssim(pred, gt)))
    # the fixture's last validation, of the same state
    got = {m["tag"]: m["value"] for m in _metrics(run) if m["step"] == 12}
    assert abs(got["test/psnr"] - np.mean(psnrs)) <= 1e-5
    assert abs(got["test/ssim"] - np.mean(ssims)) <= 1e-5


def test_port_checkpoint_loads_in_jax(run):
    ck = jck.load_ckpt(_path(run, "ckpts", "t", "epoch=1.ckpt"))
    system = run.system
    for a, b in zip(tree_leaves(system.params),
                    jax.tree_util.tree_leaves(ck["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for k, v in system.model_state.items():
        np.testing.assert_array_equal(v.numpy(), ck["model_state"][k])


def test_auto_resume_skips_a_torn_checkpoint_and_finishes_the_run(run):
    src = os.path.join(run.work, "ckpts", *RUN, "t")
    dst = os.path.join(run.work, "ckpts", *RUN, "resume")
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "epoch=0.ckpt"), dst)
    with open(os.path.join(src, "epoch=1.ckpt"), "rb") as f:
        data = f.read()
    with open(os.path.join(dst, "epoch=1.ckpt"), "wb") as f:
        f.write(data[:len(data) // 2])               # a torn write
    os.chdir(run.work)
    system = system_for(run.root, "resume", "--no_save_test")
    system.setup()
    assert system.auto_resume()
    assert system.global_step == 6
    ck0 = load_ckpt(os.path.join(dst, "epoch=0.ckpt"))
    for a, b in zip(tree_leaves(system.params),
                    jax.tree_util.tree_leaves(ck0["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    opt = system.trainer.optimizer
    assert all(float(opt.state[p]["step"]) == 6
               for p in tree_leaves(system.trainer.bundle))
    system.fit()                                     # epoch 1 only
    assert system.global_step == 12
    assert int(load_ckpt(os.path.join(dst, "epoch=1.ckpt"))["step"]) == 12
    with open(_path(run, "logs", "resume", "log.txt")) as f:
        log = f.read()
    assert "could not load" in log and "at step 6" in log
    system.close()


def test_lr_schedule_is_the_jax_closure(run):
    h = run.system.h
    stub = types.SimpleNamespace(
        h=h, train_dataset=types.SimpleNamespace(STEPS_PER_EPOCH=6),
        ext_params=None, _bundle_params=lambda: {"w": jnp.zeros(2)})
    JNeRFSystem.configure_optimizers(stub)
    for step in range(24):
        np.testing.assert_allclose(run.system.lr_schedule(step),
                                   float(stub.lr_schedule(step)),
                                   rtol=2**-22)


def test_adaptive_budget_flag(run):
    """--no-adaptive_budget: auto-K union budget, no utilization read and
    no re-pick; the default re-picks from step 16 on (warmup 0 here)."""
    os.chdir(run.work)
    for flag, factor in (("--no-adaptive_budget", 0.0),
                         ("--adaptive_budget", 1.0)):
        system = system_for(run.root, "budget", flag, "--warmup_steps", "0")
        system.setup()
        tr = system.trainer
        assert tr.rcfg.union_budget_factor == factor
        tr.fit_steps(17)
        if factor == 0.0:
            assert tr.last_budget_util is None
            assert tr.rcfg.budget_per_ray == 64
        else:
            # the untrained grids keep most cells: the union buffer fills
            assert tr.last_budget_util > 0.95
            assert tr.rcfg.budget_per_ray == tt.next_budget_bucket(
                64, tr.last_budget_util, tr.buckets) > 64
        system.close()


def test_random_bg_draws_a_background_per_step(run):
    """At scale > 0.5 (black background), --random_bg draws a colour per
    expert from the trainer's generator on every evaluation; without it
    handing the generator in changes no bit."""
    os.chdir(run.work)
    losses = {}
    for flag in ("--random_bg", None):
        extra = ["--scale", "1.0"] + ([flag] if flag else [])
        system = system_for(run.root, "bg", *extra)
        system.setup()
        tr = system.trainer
        tr.update_grid(warmup=True)
        batch = tt.sample_batch(tr.gen, tr.data, 256)

        def loss(gen):
            with torch.no_grad():
                return float(tt.loss_fn(tr.bundle, tr.model_state, batch,
                                        tr.data, tr.cfg, tr.rcfg, tr.tcfg,
                                        gen)[0])

        losses[flag] = (loss(tr.gen), loss(tr.gen), loss(None))
        system.close()
    a, b, _ = losses["--random_bg"]
    assert a != b
    a, b, c = losses[None]
    assert a == b == c


def test_oracle_renders_the_last_validation_again(run):
    os.chdir(run.work)
    ckpt = _path(run, "ckpts", "t", "epoch=1.ckpt")
    got = oracle.main(args(run.root, "oracle", "--moe_training",
                           "--ckpt_path", ckpt), device="cpu")
    last = [m["value"] for m in _metrics(run) if m["tag"] == "test/psnr"][0]
    assert abs(got["psnr"] - last) <= 1e-9
    assert sorted(os.listdir(os.path.join(run.work, "results", *RUN,
                                          "oracle")))[0] == "000epoch0.png"


def test_val_only_and_weight_path(run):
    """--val_only validates a checkpoint without training; --weight_path
    warm-starts the parameters (not the gate, Adam or grids)."""
    os.chdir(run.work)
    ckpt = _path(run, "ckpts", "t", "epoch=1.ckpt")
    system = train_ml.main(args(run.root, "val_only", "--val_only",
                                "--ckpt_path", ckpt), device="cpu")
    assert system.global_step == 12
    assert [m["tag"] for m in _metrics(run, "val_only")] == ["test/psnr",
                                                             "test/ssim"]
    system.close()
    slim = _path(run, "ckpts", "t", "epoch=1_slim.ckpt")
    system = system_for(run.root, "warm", "--weight_path", slim)
    system.setup()
    want = load_ckpt(slim)
    for a, b in zip(tree_leaves(system.params),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert system.global_step == 0
    assert not system.model_state["occ"].any()
    system.close()


def test_a_jax_checkpoint_resumes_in_the_system(run, tmp_path):
    """A file of the JAX package's save_ckpt, with optax's Adam state (a
    constant learning rate: EmptyState) over the fixture's trained
    parameters, doubled."""
    ck = load_ckpt(_path(run, "ckpts", "t", "epoch=1.ckpt"))
    bundle = jax.tree_util.tree_map(
        lambda a: a * 2, {"model": ck["params"], "gate": ck["gate_params"]})
    opt = optax.adam(1e-2, eps=1e-15)
    grads = jax.tree_util.tree_map(lambda p: np.full_like(p, 1e-3), bundle)
    _, opt_state = jax.jit(lambda g, p: opt.update(g, opt.init(p), p))(
        grads, bundle)
    path = str(tmp_path / "epoch=0.ckpt")
    jck.save_ckpt(path, {
        "params": bundle["model"], "gate_params": bundle["gate"],
        "opt_state": opt_state, "model_state": ck["model_state"],
        "step": 6, "hparams": {"resolved_hash_impl": "brick3"}})
    os.chdir(run.work)
    system = system_for(run.root, "from_jax")
    system.setup()
    system.resume(path)
    assert system.global_step == 6
    leaves = tree_leaves(system.trainer.bundle)
    for p, b, m in zip(leaves, jax.tree_util.tree_leaves(bundle),
                       jax.tree_util.tree_leaves(opt_state[0].mu)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            system.trainer.optimizer.state[p]["exp_avg"].numpy(),
            np.asarray(m))
    system.close()


@pytest.mark.parametrize("extra", [
    ["--layout", "dense"], ["--num_devices", "2"], ["--multihost"]])
def test_unported_flags_are_refused(tmp_path, monkeypatch, extra):
    """The three flags this test once saw refused are ported now (the
    name is kept so that its history reads on): --layout dense is
    accepted (its training runs in test_torch_dense); --num_devices 2,
    once refused, builds a 2-rank
    mesh on two processes (parallel.launch; its training runs in
    test_torch_parallel); --multihost, once refused, joins a launcher's
    group, and without the launcher's environment raises naming what is
    missing, before anything is written."""
    monkeypatch.chdir(tmp_path)
    if extra[0] == "--layout":
        system = system_for("nowhere", "x", *extra)
        assert system.h.layout == "dense" and system.mesh.size == 1
        system.close()
        return
    if extra[0] == "--num_devices":
        monkeypatch.setattr(tmesh, "TIMEOUT", tmesh.datetime.timedelta(
            seconds=300))
        h = get_opts(args("nowhere", "x", *extra))
        system = tmesh.launch(2, tt.NeRFSystem, (h, "cpu"), device="cpu")
        assert (system.mesh.size, system.mesh.rank) == (2, 0)
        assert system.device == torch.device("cpu")
        system.close()
        assert os.listdir(tmp_path) == ["logs"]
        return
    for k in tmesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="not set: MASTER_ADDR, "
                       "MASTER_PORT, RANK, WORLD_SIZE"):
        system_for("nowhere", "x", *extra)
    assert os.listdir(tmp_path) == []


def test_ckpt_backend_orbax_trains_checkpoints_and_resumes(run):
    """--ckpt_backend orbax: the epochs' files written in the background
    are the JAX layout's pickles (the slim export waited for the last);
    --resume auto continues from them with the Adam state."""
    os.chdir(run.work)
    flags = ("--ckpt_backend", "orbax", "--no_save_test")
    system = train_ml.main(args(run.root, "orbax", "--num_epochs", "1",
                                *flags), device="cpu")
    assert system.ckpt_writer is not None and system.global_step == 6
    system.close()
    names = sorted(os.listdir(_path(run, "ckpts", "orbax", "")))
    assert names == ["epoch=0.ckpt", "epoch=0_slim.ckpt"]
    first = load_ckpt(_path(run, "ckpts", "orbax", "epoch=0.ckpt"))
    assert int(first["step"]) == 6 and int(first["opt_state"]["count"]) == 6
    for a, b in zip(tree_leaves(system.params),
                    jax.tree_util.tree_leaves(first["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    resumed = train_ml.main(args(run.root, "orbax", "--num_epochs", "2",
                                 "--resume", "auto", *flags), device="cpu")
    resumed.close()
    assert resumed.global_step == 12
    last = load_ckpt(_path(run, "ckpts", "orbax", "epoch=1.ckpt"))
    assert int(last["step"]) == 12 and int(last["opt_state"]["count"]) == 12
    with open(_path(run, "logs", "orbax", "log.txt")) as f:
        assert "resumed from" in f.read()


def test_single_field_trains_validates_checkpoints_and_renders(run):
    """train.py's single NGP field (no --moe_training): two epochs with a
    validation, full and slim checkpoints without gate_params (unstacked
    grids, the Adam state over {"model"}), and the oracle, also without
    --moe_training, rendering the last validation again."""
    from radnerf_tpu_torch.train.__main__ import main as train_main

    os.chdir(run.work)
    system = train_main(args(run.root, "single"), device="cpu")
    system.close()
    assert not system.moe and system.gate_params is None
    assert system.global_step == 12
    full = load_ckpt(_path(run, "ckpts", "single", "epoch=1.ckpt"))
    assert "gate_params" not in full
    assert set(full["opt_state"]["mu"]) == {"model"}
    assert full["model_state"]["density_grid"].shape == (1, 32**3)
    assert set(full["params"]["geo"]) == {"w", "b"}
    assert full["params"]["geo"]["w"][0].shape == (8, 64)   # unstacked
    slim = load_ckpt(_path(run, "ckpts", "single", "epoch=1_slim.ckpt"))
    assert set(slim) == {"params", "step", "hparams"}
    pngs = sorted(os.listdir(os.path.join(run.work, "results", *RUN,
                                          "single")))
    assert pngs == ["000epoch1.png", "000epoch1_d.png", "001epoch1.png",
                    "001epoch1_d.png"]
    last = [m["value"] for m in _metrics(run, "single")
            if m["tag"] == "test/psnr"][-1]
    got = oracle.main(args(run.root, "single_oracle", "--ckpt_path",
                           _path(run, "ckpts", "single", "epoch=1.ckpt")),
                      device="cpu")
    assert abs(got["psnr"] - last) <= 1e-9


def test_host_sampling_is_accepted_and_changes_nothing(run):
    """--host_sampling has no code behind it in the JAX package (opt.py
    declares it; nothing reads it), so it is accepted and the steps are
    the same with and without it."""
    os.chdir(run.work)
    params = []
    for extra in ((), ("--host_sampling",)):
        system = system_for(run.root, "host", "--no_save_test", *extra)
        system.setup()
        system.trainer.fit_steps(3)
        params.append([p.detach().clone() for p in
                       tree_leaves(system.trainer.bundle)])
        system.close()
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_train_entry_runs_the_moe_system_and_refuses_the_single_field(
        run, monkeypatch):
    """python -m radnerf_tpu_torch.train (the twin of train.py) runs both
    systems: with --moe_training the NeRFSystem of train_ml (the gate in
    its checkpoint); without it the single NGP field, which it used to
    refuse (the test keeps its name)."""
    from radnerf_tpu_torch.train.__main__ import main as train_main

    os.chdir(run.work)
    for exp, extra, moe in (("train_py", ["--moe_training"], True),
                            ("train_py_single", [], False)):
        system = train_main(args(run.root, exp, *extra, "--num_epochs", "1",
                                 "--no_save_test"), device="cpu")
        assert system.global_step == 6 and system.moe == moe
        ck = load_ckpt(_path(run, "ckpts", exp, "epoch=0.ckpt"))
        assert ("gate_params" in ck) == moe
        assert ck["params"]["hash_table"].shape == (4, 2**11, 2)
        system.close()


def test_flags_are_the_jax_flags():
    def flags(parser):
        return {a.dest: (a.default, a.choices, a.type, a.nargs,
                         type(a).__name__)
                for a in parser._actions}

    assert flags(get_parser()) == flags(j_get_parser())
    assert len(flags(get_parser())) == 63        # 62 flags and --help
