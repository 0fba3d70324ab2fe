"""Data parallelism over ranks (radnerf_tpu_torch/parallel/) against the JAX
package's mesh (radnerf_tpu/parallel/), on the CPU.

The port's ranks are processes in a gloo group that meets in a file store
(no TCP port, so xdist workers cannot collide); every process started
here has its own time limit. The JAX side runs on the conftest's eight
virtual CPU devices, its Pallas kernels in interpret mode.

- the 2-rank `make_grad_fn` and `make_train_step` (the union flat MoE
  render with the jitter in the batch, nerf_loss with the cv term, one
  Adam update) against JAX's on `make_mesh(2)`: both estimate the cv
  term on each shard and average;
- the 2-rank step against the 1-rank step with two accumulation slices
  on the same global batch (the same slices: equal bit for bit);
- `initialize_multihost` with explicit arguments, idempotent, and one
  cross-process all-reduce;
- `launch`: a rank that dies before or after joining the group fails the
  launch within seconds; more ranks than cards are refused;
- `shard_batch`'s blocks in JAX's P("ray") order, `n_microbatch` on the
  local batch, a batch that does not divide refused;
- `train_ml.main` and `train_other.main` with `--num_devices 2` past a
  grid update: both ranks' parameters, Adam moments and grids bit-equal,
  one checkpoint an epoch, one log.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu.losses import nerf_loss as j_nerf_loss
from radnerf_tpu.losses import total_loss as j_total_loss
from radnerf_tpu.metrics import psnr as j_psnr
from radnerf_tpu.parallel import mesh as jmesh
from radnerf_tpu.parallel import step as jstep
from radnerf_tpu.render.ml_render import ml_render_train as j_ml_render_train
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu_torch import train_ml, train_other
from radnerf_tpu_torch.parallel import mesh as tmesh
from radnerf_tpu_torch.parallel.step import (
    shard_batch, tree_leaves, tree_paths,
)
from radnerf_tpu_torch.train import other_trainer as tot
from radnerf_tpu_torch.train import trainer as tt

from .fixtures import make_nsvf_dataset
from .test_torch_ml_train import (  # noqa: F401  (patched: a fixture)
    CFG_KW, GRAD_RTOL, GRAD_RTOL_DEFAULT, LOSS_W, RENDER_KW, _np, _setup,
    patched,
)

ROOT = Path(__file__).resolve().parents[1]
N_RAYS = 256                # the global batch: 128 rays a rank
LR = 1e-2
WORKER_TIMEOUT = 300        # seconds, each process

torch.set_num_threads(1)

# one rank of the port's step: the batch's rays through the union flat
# MoE render, nerf_loss with the opacity, cv and depth-mutual terms;
# make_grad_fn, then make_train_step with Adam (eps 1e-15). World 1 takes
# the whole batch in two accumulation slices, world 2 a block a rank.
_WORKER = textwrap.dedent(r"""
    import pickle, sys
    import torch
    torch.set_num_threads(1)
    from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
    from radnerf_tpu_torch.losses import nerf_loss, total_loss
    from radnerf_tpu_torch.metrics import psnr
    from radnerf_tpu_torch.models.mngp import MNGPConfig
    from radnerf_tpu_torch.parallel import (
        initialize_multihost, make_grad_fn, make_mesh, make_train_step,
        shard_batch)
    from radnerf_tpu_torch.parallel.step import tree_leaves
    from radnerf_tpu_torch.render.ml_render import ml_render_train
    from radnerf_tpu_torch.render.render import RenderConfig

    inp, out, world, rank, store = sys.argv[1:6]
    world, rank = int(world), int(rank)
    with open(inp, "rb") as f:
        x = pickle.load(f)
    if world > 1:
        initialize_multihost(store, world, rank, device="cpu")
    mesh = make_mesh(world, "cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    cfg, rcfg = MNGPConfig(**x["cfg_kw"]), RenderConfig(**x["render_kw"])
    model, gate = params_from_jax(x["model"], x["gate"], device="cpu")
    bundle = {"model": model, "gate": gate}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    state = state_from_jax(x["state"], device="cpu")
    batch = shard_batch({k: torch.from_numpy(v)
                         for k, v in x["batch"].items()}, mesh)

    def loss_fn(b, s, bt, data):
        out = ml_render_train(b["model"], s, cfg, b["gate"], bt["rays_o"],
                              bt["rays_d"], bt["rays_d"], rcfg, "ray",
                              noise=bt["noise"])
        ld = nerf_loss(out, {"rgb": bt["rgb"]}, **x["loss_w"])
        return total_loss(ld), {
            "psnr": psnr(out["rgb"], bt["rgb"]),
            "rm_samples": out["rm_samples"].to(torch.float32)}

    res = {}
    loss, grads = make_grad_fn(loss_fn, mesh)(bundle, state, batch, {})
    res["grad_fn"] = (float(loss), [g.numpy() for g in tree_leaves(grads)])
    opt = torch.optim.Adam(tree_leaves(bundle), lr=x["lr"], eps=1e-15)
    step = make_train_step(loss_fn, opt, 2 if world == 1 else 1, mesh)
    loss, aux = step(bundle, state, batch, {})
    res["step"] = (float(loss), {k: float(v) for k, v in aux.items()},
                   [p.grad.numpy() for p in tree_leaves(bundle)],
                   [p.detach().numpy() for p in tree_leaves(bundle)])
    with open(out, "wb") as f:
        pickle.dump(res, f)
    if world > 1:
        torch.distributed.destroy_process_group()
""")

# initialize_multihost with explicit arguments, twice, then one
# all-reduce across the two processes
_INIT_WORKER = textwrap.dedent(r"""
    import sys
    import torch
    from radnerf_tpu_torch.parallel import (
        distributed_is_initialized, initialize_multihost, make_mesh)

    store, pid = sys.argv[1], int(sys.argv[2])
    assert not distributed_is_initialized()
    initialize_multihost(store, 2, pid, device="cpu")
    assert distributed_is_initialized()
    initialize_multihost(store, 2, pid, device="cpu")   # a no-op
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (2, pid, "cpu")
    x = torch.tensor([pid + 1.0])
    torch.distributed.all_reduce(x)
    assert float(x) == 3.0, float(x)
    torch.distributed.destroy_process_group()
    print(f"WORKER{pid} OK", flush=True)
""")


def _run(script: str, argvs: list, tmp_path) -> list:
    """Run `script` once per argv, all at once, each within
    WORKER_TIMEOUT; returns their outputs (fails on a nonzero exit)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv],
                              cwd=tmp_path, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _rays(n=N_RAYS, seed=5):
    """n rays from radius 1.2 aimed into the box, target colours and the
    start jitter."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return {"rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32),
            "rgb": rng.random((n, 3), dtype=np.float32),
            "noise": rng.random(n, dtype=np.float32)}


def _port_steps(tmp_path, jbundle, jstate, batch, world):
    """The worker's results on each of `world` ranks."""
    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"cfg_kw": CFG_KW, "render_kw": RENDER_KW,
                     "loss_w": LOSS_W, "lr": LR,
                     "model": _np(jbundle["model"]),
                     "gate": _np(jbundle["gate"]),
                     "state": _np(jstate), "batch": batch}, f)
    store = f"file://{tmp_path / f'store{world}'}"
    outs = [tmp_path / f"out{world}_{r}.pkl" for r in range(world)]
    _run(_WORKER, [[str(inp), str(out), str(world), str(r), store]
                   for r, out in enumerate(outs)], tmp_path)
    res = []
    for out in outs:
        with open(out, "rb") as f:
            res.append(pickle.load(f))
    return res


def _rtol(name):
    return next((v for k, v in GRAD_RTOL.items() if k in name),
                GRAD_RTOL_DEFAULT)


def test_two_rank_grad_fn_and_step_match_jax_on_two_devices(tmp_path,
                                                            patched):
    """Loss and PSNR within 1e-3 and every gradient leaf within its
    test_torch_ml_train tolerance of its largest entry (bf16 MLPs on both
    sides, the reference's quantized table gradient), rm_samples equal;
    Adam's first update -lr g / (|g| + 1e-15) of every parameter, the
    port's and the JAX one, as from a gradient within that tolerance of
    the port's (test_torch_baselines' rule). Both ranks hold the same
    values."""
    jcfg, jbundle, jstate = _setup()
    rcfg = JRender(**RENDER_KW)

    def loss_fn(bundle, model_state, b, data, key):
        out = j_ml_render_train(
            bundle["model"], model_state, jcfg, bundle["gate"],
            b["rays_o"], b["rays_d"], b["rays_d"], key, rcfg, "ray",
            noise=b["noise"])
        ld = j_nerf_loss(out, {"rgb": b["rgb"]}, **LOSS_W)
        return j_total_loss(ld), {
            "psnr": j_psnr(out["rgb"], b["rgb"]),
            "rm_samples": out["rm_samples"].astype(jnp.float32)}

    mesh = jmesh.make_mesh(2)
    batch = _rays()
    jb = jstep.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                           mesh)
    key = jax.random.PRNGKey(7)
    gl, gg = jstep.make_grad_fn(loss_fn, mesh)(jbundle, jstate, jb, {}, key)
    opt = optax.adam(LR, eps=1e-15)
    new, _, sl, saux = jstep.make_train_step(
        loss_fn, opt, mesh, donate=False)(
        jbundle, opt.init(jbundle), jstate, jb, {}, key)

    ranks = _port_steps(tmp_path, jbundle, jstate, batch, 2)
    paths = tree_paths(_np(jbundle))
    jgrads = jax.tree_util.tree_leaves(_np(gg))
    jnew = jax.tree_util.tree_leaves(_np(new))
    jold = jax.tree_util.tree_leaves(_np(jbundle))
    for res in ranks:
        loss, grads = res["grad_fn"]
        np.testing.assert_allclose(loss, float(gl), rtol=1e-3)
        np.testing.assert_allclose(res["step"][0], float(sl), rtol=1e-3)
        aux = res["step"][1]
        assert aux["rm_samples"] == float(saux["rm_samples"]) > 0
        np.testing.assert_allclose(aux["psnr"], float(saux["psnr"]),
                                   rtol=1e-3)
        assert len(grads) == len(jgrads) == len(paths)
        for path, got, ref in zip(paths, grads, jgrads):
            scale = np.abs(ref).max()
            assert scale > 0, path
            assert np.abs(got - ref).max() <= _rtol(path) * scale, (
                path, np.abs(got - ref).max() / scale)
        adam = lambda g: g / (np.abs(g) + 1e-15)
        for path, g, p0, p1, r1 in zip(paths, res["step"][2], jold,
                                       res["step"][3], jnew):
            g = g.astype(np.float64)
            delta = _rtol(path) * np.abs(g).max()
            for moved in (p0 - p1, p0 - r1):
                u = moved / LR
                assert ((u >= adam(g - delta) - 1e-4)
                        & (u <= adam(g + delta) + 1e-4)).all(), path
    for a, b in zip(ranks[0]["step"][3], ranks[1]["step"][3]):
        np.testing.assert_array_equal(a, b)


def test_two_rank_step_equals_one_rank_with_two_slices(tmp_path):
    """Two ranks of 128 rays and one rank with two 128-ray accumulation
    slices take the same slices, each its own cv estimate: the loss, the
    aux, every gradient leaf and the updated parameters bit-equal (a sum
    of two and a halving, in either order)."""
    _, jbundle, jstate = _setup()
    batch = _rays()
    (one,) = _port_steps(tmp_path, jbundle, jstate, batch, 1)
    two = _port_steps(tmp_path, jbundle, jstate, batch, 2)
    for res in two:
        assert res["step"][:2] == one["step"][:2]
        for kind in (2, 3):
            for a, b in zip(res["step"][kind], one["step"][kind]):
                np.testing.assert_array_equal(a, b)


def test_initialize_multihost_explicit_args_idempotent_all_reduce(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    outs = _run(_INIT_WORKER, [[store, "0"], [store, "1"]], tmp_path)
    for pid, out in enumerate(outs):
        assert f"WORKER{pid} OK" in out


class _ExitOnUnpickle:
    """Unpickles as os._exit(3): the spawned rank that receives it in its
    arguments dies before it joins the group."""

    def __reduce__(self):
        return (os._exit, (3,))


def _die_after_joining():
    if torch.distributed.get_rank() == 1:
        raise SystemExit(5)
    torch.distributed.all_reduce(torch.ones(1))


@pytest.mark.parametrize("when", ["before_joining", "after_joining"])
def test_launch_fails_at_once_when_a_rank_dies(when, monkeypatch):
    """A spawned rank that dies before it joins the group fails the launch
    as soon as rank 0 sees its exit, not at the group's timeout; one that
    dies after joining fails rank 0's next gloo collective."""
    monkeypatch.setattr(tmesh, "TIMEOUT", tmesh.datetime.timedelta(
        seconds=WORKER_TIMEOUT))
    t0 = time.monotonic()
    if when == "before_joining":
        with pytest.raises(RuntimeError, match=r"ended before joining the "
                           r"group: rank1 \(exit code 3\)"):
            tmesh.launch(2, print, (_ExitOnUnpickle(),), device="cpu")
    else:
        with pytest.raises(RuntimeError):
            tmesh.launch(2, _die_after_joining, device="cpu")
    assert time.monotonic() - t0 < 60
    assert not tmesh.distributed_is_initialized()


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards, one a "
                       "rank; this host has 1"):
        tmesh.launch(2, print, device="cuda")


def test_shard_batch_blocks_follow_jax_ray_sharding():
    """Rank r's block is the rows that JAX's P("ray") places on the
    mesh's r-th device."""
    batch = {"a": np.arange(24, dtype=np.float32).reshape(8, 3),
             "b": np.arange(8, dtype=np.int32)}
    jb = jstep.shard_batch(batch, jmesh.make_mesh(4))
    for name in batch:
        shards = sorted(jb[name].addressable_shards,
                        key=lambda s: s.device.id)
        for r, s in enumerate(shards):
            mesh = tmesh.Mesh(4, r, torch.device("cpu"))
            got = shard_batch({k: torch.from_numpy(v)
                               for k, v in batch.items()}, mesh)[name]
            np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))


def test_n_microbatch_counts_the_local_batch():
    """JAX's rule (trainer.py: local = batch // devices, one slice per
    2048 local rays), and an explicit --microbatch as it stands."""
    for batch, ranks in ((8192, 1), (8192, 2), (8192, 4), (2048, 2),
                         (6144, 2)):
        local = batch // ranks
        tcfg = tt.TrainConfig(batch_size=batch)
        assert tt.n_microbatch(tcfg, ranks) == max(1, -(-local // 2048))
    assert tt.n_microbatch(tt.TrainConfig(batch_size=8192), 2) == 2
    assert tt.n_microbatch(tt.TrainConfig(batch_size=8192), 1) == 4
    assert tt.n_microbatch(tt.TrainConfig(batch_size=8192,
                                          microbatch=4), 2) == 4


def test_a_batch_that_does_not_divide_by_the_ranks_is_refused():
    mesh = tmesh.Mesh(4, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by 4 ranks"):
        shard_batch({"a": torch.zeros(10)}, mesh)
    tcfg = tt.TrainConfig(batch_size=10)
    data = {"directions": torch.zeros(4, 3), "poses": torch.zeros(1, 3, 4),
            "rays": torch.zeros(1, 4, 3)}
    with pytest.raises(ValueError, match="not divisible by 4 ranks"):
        tt.Trainer(None, tcfg, {}, None, {}, data, torch.Generator(),
                   mesh=mesh)


# ------------------------------------------------------ the entry points

SMALL = dict(grid_size=32, n_levels=4)
RUN = ("Synthetic_NeRF", "TestSphere")
OTHER_RANK = train_ml._other_rank


def _cut_grids(mp):
    """The density grids cut to 32^3 and the levels to 4 (and brick3 for
    the baselines), as the system tests cut them."""
    for mod, name in ((tt, "MNGPConfig"), (tt, "NGPConfig"),
                      (tot, "SwitchNGPConfig"), (tot, "BlockNGPConfig")):
        kw = SMALL if mod is tt else {**SMALL, "hash_impl": "brick3"}
        mp.setattr(mod, name, functools.partial(getattr(mod, name), **kw))


def _state(system) -> dict:
    tr = system.trainer
    leaves = tree_leaves(tr.bundle)
    return {"params": [p.detach().numpy() for p in leaves],
            "adam": [tr.optimizer.state[p][k].numpy() for p in leaves
                     for k in ("exp_avg", "exp_avg_sq")],
            "grids": [v.numpy() for v in tree_leaves(tr.model_state)],
            "step": tr.global_step}


def small_grid_rank(hparams, device, system_cls):
    """Rank 1 of train_ml.run with the cut grids: trains, then leaves its
    state and the number of files it wrote through save_ckpt in
    rank1.pkl in the working directory. It runs on one thread, as rank
    0 does (this module sets it on import): CPU matrix products at other
    thread counts round differently, and warmup grid updates are not
    broadcast."""
    written = []
    with pytest.MonkeyPatch.context() as mp:
        _cut_grids(mp)
        mp.setattr(tt, "save_ckpt", lambda *a: written.append(a[0]))
        system = train_ml.train(hparams, device, None, system_cls)
    with open("rank1.pkl", "wb") as f:
        pickle.dump({**_state(system), "written": written,
                     "mesh": (system.mesh.size, system.mesh.rank)}, f)
    system.close()


def _args(root, exp, *extra):
    return ["--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", RUN[0], "--scene_name", RUN[1],
            "--exp_name", exp, "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "11",
            "--batch_size", "256", "--num_epochs", "2",
            "--steps_per_epoch", "9", "--model_zoo_size", "2",
            "--hash_impl", "brick3", "--val_chunk", "1024",
            "--num_devices", "2", *extra]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nsvf_dataset(str(tmp_path_factory.mktemp("data")))


@pytest.mark.parametrize("entry", ["train_ml", "train_other_switch"])
def test_entry_point_trains_on_two_ranks(entry, scene, tmp_path,
                                         monkeypatch):
    """18 steps on two gloo ranks (grid updates at steps 0 and 16): the
    ranks' parameters, Adam moments and grids bit-equal; rank 0 wrote
    one checkpoint an epoch and the slim export, rank 1 nothing; the
    metrics and the log written once."""
    monkeypatch.chdir(tmp_path)
    _cut_grids(monkeypatch)
    monkeypatch.setattr(train_ml, "_other_rank", small_grid_rank)
    monkeypatch.setattr(tmesh, "TIMEOUT", tmesh.datetime.timedelta(
        seconds=WORKER_TIMEOUT))
    written = []
    save = tt.save_ckpt
    monkeypatch.setattr(tt, "save_ckpt",
                        lambda path, p: (written.append(path),
                                         save(path, p)))
    steps = []
    on_step = lambda s, loss, aux: steps.append(float(loss))
    if entry == "train_ml":
        system = train_ml.main(_args(scene, "dp"), device="cpu",
                               on_step=on_step)
    else:
        system = train_other.main(
            _args(scene, "dp", "--model_type", "switch", "--gate_type",
                  "point", "--cv_loss_w", "1e-4", "--samples_per_ray",
                  "48"), device="cpu", on_step=on_step)
    system.close()
    with open("rank1.pkl", "rb") as f:
        rank1 = pickle.load(f)
    assert (system.mesh.size, system.mesh.rank) == (2, 0)
    assert rank1["mesh"] == (2, 1) and rank1["written"] == []
    assert len(steps) == 18 and all(np.isfinite(steps))
    rank0 = _state(system)
    assert rank0["step"] == rank1["step"] == 18
    for key in ("params", "adam", "grids"):
        assert len(rank0[key]) == len(rank1[key]) > 0
        for a, b in zip(rank0[key], rank1[key]):
            np.testing.assert_array_equal(a, b)
    ckpts = os.path.join("ckpts", *RUN, "dp")
    names = ["epoch=0.ckpt", "epoch=1.ckpt", "epoch=1_slim.ckpt"]
    assert sorted(os.listdir(ckpts)) == names
    assert sorted(os.path.basename(p) for p in written) == names
    logs = os.path.join("logs", *RUN, "dp")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        tags = [(m["tag"], m["step"]) for m in map(json.loads, f)]
    assert tags.count(("train/loss", 0)) == 1
    assert tags.count(("test/psnr", 18)) == 1
    with open(os.path.join(logs, "log.txt")) as f:
        log = f.read()
    assert log.count("epoch 0 step 0:") == 1
