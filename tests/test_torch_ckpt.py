"""Checkpoints across the two packages: a file written by the JAX
package's save_ckpt (init_mngp parameters, init_mngp_state, an optax Adam
state after two updates, step and hparams) loads in the port without
importing optax or JAX, with equal parameters, grids and Adam moments
and an equal next Adam update; a port-written file loads in the JAX
package's load_ckpt; slim_ckpt and load_weights_into agree; a failed save
leaves nothing at its path; a file naming any other class is refused."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu.models.gates import init_ray_gate as j_init_gate
from radnerf_tpu.models.mngp import MNGPConfig as JCfg
from radnerf_tpu.models.mngp import init_mngp as j_init_mngp
from radnerf_tpu.models.mngp import init_mngp_state as j_init_state
from radnerf_tpu.utils import ckpt as jck
from radnerf_tpu_torch import convert
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mngp import (
    MNGPConfig, init_mngp, init_mngp_state,
)
from radnerf_tpu_torch.parallel.step import tree_leaves
from radnerf_tpu_torch.utils import ckpt as tck

ROOT = Path(__file__).resolve().parents[1]
CFG = JCfg(scale=0.5, grid_size=16, n_levels=4, log2_T=10, n_experts=2,
           compute_dtype="bfloat16", hash_impl="brick3")
LR, SPE, EPOCHS = 1e-2, 3, 4


def j_schedule(step):
    """radnerf_tpu NeRFSystem.configure_optimizers' closure."""
    eta_min = LR / 30
    epoch = jnp.minimum(step // SPE, EPOCHS)
    return eta_min + 0.5 * (LR - eta_min) * (
        1 + jnp.cos(jnp.pi * epoch / EPOCHS))


def _grads(bundle, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
        * 1e-2, bundle)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX checkpoint after two optax Adam updates, and the optax state
    and parameters to continue from."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    bundle = {"model": j_init_mngp(k1, CFG), "gate": j_init_gate(k2, 2)}
    state = jax.tree_util.tree_map(np.asarray, j_init_state(CFG))
    state["density_grid"] = np.random.default_rng(0).random(
        state["density_grid"].shape, dtype=np.float32)
    state["occ"] = state["density_grid"].reshape(state["occ"].shape) > 0.5
    opt = optax.adam(j_schedule, eps=1e-15)
    opt_state = opt.init(bundle)
    for seed in (1, 2):
        upd, opt_state = opt.update(_grads(bundle, seed), opt_state, bundle)
        bundle = optax.apply_updates(bundle, upd)
    path = str(tmp_path_factory.mktemp("ck") / "epoch=0.ckpt")
    jck.save_ckpt(path, {
        "params": bundle["model"], "gate_params": bundle["gate"],
        "opt_state": opt_state, "model_state": state, "step": 2,
        "hparams": {"resolved_hash_impl": "brick3", "lr": LR},
    })
    return path, bundle, opt, opt_state, state


PROBE = r"""
import sys
from radnerf_tpu_torch.utils.ckpt import load_ckpt
from radnerf_tpu_torch.convert import adam_state_from_jax
c = load_ckpt(sys.argv[1])
st = adam_state_from_jax(c["opt_state"])
print("count", int(st["count"]), int(st["schedule_count"]), int(c["step"]))
print("BAD", sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                           "radnerf_tpu")))
"""


def test_jax_checkpoint_loads_without_optax_or_jax(jax_ckpt):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE, jax_ckpt[0]],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-2] == "count 2 2 2", res.stdout
    assert lines[-1] == "BAD []", res.stdout


def test_jax_checkpoint_resumes_in_the_port(jax_ckpt):
    path, bundle, opt, opt_state, state = jax_ckpt
    ck = tck.load_ckpt(path)
    params, gate = convert.params_from_jax(ck["params"], ck["gate_params"],
                                           device="cpu")
    tbundle = {"model": params, "gate": gate}
    for a, b in zip(tree_leaves(tbundle), jax.tree_util.tree_leaves(bundle)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tstate = convert.state_from_jax(ck["model_state"], device="cpu")
    for k in state:
        np.testing.assert_array_equal(tstate[k].numpy(), state[k])
    assert int(ck["step"]) == 2
    assert str(ck["hparams"]["resolved_hash_impl"]) == "brick3"

    # the Adam state on a bundle of zeros: the next step then leaves each
    # leaf holding exactly its update, to compare with optax's
    zeros = {"model": jax.tree_util.tree_map(np.zeros_like, ck["params"]),
             "gate": jax.tree_util.tree_map(np.zeros_like,
                                            ck["gate_params"])}
    zb = {k: convert.params_from_jax(v, device="cpu")[0]
          for k, v in zeros.items()}
    leaves = tree_leaves(zb)
    topt = torch.optim.Adam(leaves, lr=float(j_schedule(2)), eps=1e-15)
    adam = convert.adam_state_from_jax(ck["opt_state"])
    convert.load_adam_state(topt, zb, adam)
    for p, m, v in zip(leaves, jax.tree_util.tree_leaves(opt_state[0].mu),
                       jax.tree_util.tree_leaves(opt_state[0].nu)):
        st = topt.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(m))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(v))
    g = _grads(bundle, 3)
    upd, _ = opt.update(g, opt_state, bundle)
    for p, gj in zip(leaves, jax.tree_util.tree_leaves(g)):
        p.grad = torch.from_numpy(np.array(gj))
    topt.step()
    # optax computes its bias corrections 1 - b^t in float32, which at t
    # = 3 carries a relative error of its own (2.7e-5 for b2 = 0.999, by
    # cancellation); torch.optim.Adam computes them in float64. So the
    # port's update is held at 1e-6 of the leaf's largest update against
    # Adam evaluated in float64 from the restored moments, and against
    # optax's at 1e-6 plus that float32 error, measured here.
    t = 3
    bc = {b: (float(1 - b ** jnp.asarray(t, jnp.int32)), 1 - b**t)
          for b in (0.9, 0.999)}
    delta = (abs(bc[0.9][0] / bc[0.9][1] - 1)
             + 0.5 * abs(bc[0.999][0] / bc[0.999][1] - 1) + 2**-22)
    for p, u, gj, m, v in zip(
            leaves, jax.tree_util.tree_leaves(upd),
            jax.tree_util.tree_leaves(g),
            jax.tree_util.tree_leaves(opt_state[0].mu),
            jax.tree_util.tree_leaves(opt_state[0].nu)):
        got, u = p.detach().numpy().astype(np.float64), np.asarray(u)
        g64 = np.asarray(gj, np.float64)
        m64 = 0.9 * np.asarray(m, np.float64) + 0.1 * g64
        v64 = 0.999 * np.asarray(v, np.float64) + 0.001 * g64**2
        exact = -float(j_schedule(2)) * (m64 / bc[0.9][1]) / (
            np.sqrt(v64 / bc[0.999][1]) + 1e-15)
        scale = float(np.abs(u).max())
        assert float(np.abs(got - exact).max()) <= 1e-6 * scale
        assert float((np.abs(got - u) - delta * np.abs(u)).max()) \
            <= 1e-6 * scale


def test_port_checkpoint_loads_in_jax(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tcfg = MNGPConfig(scale=0.5, grid_size=16, n_levels=4, log2_T=10,
                      n_experts=2, compute_dtype="bfloat16",
                      hash_impl="brick3")
    bundle = {"model": init_mngp(gen, tcfg, device="cpu"),
              "gate": init_ray_gate(gen, 2, device="cpu")}
    opt = torch.optim.Adam(tree_leaves(bundle), lr=1e-2, eps=1e-15)
    for p in tree_leaves(bundle):
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    state = init_mngp_state(tcfg, device="cpu")
    state["occ"][0, 0, 1, 2, 3] = True
    params, gate = convert.params_to_jax(bundle["model"], bundle["gate"])
    path = str(tmp_path / "epoch=0.ckpt")
    tck.save_ckpt(path, {
        "params": params, "gate_params": gate,
        "opt_state": convert.adam_state_to_jax(opt, bundle),
        "model_state": convert.state_to_jax(state), "step": 1,
        "hparams": {"resolved_hash_impl": "brick3"},
    })
    ck = jck.load_ckpt(path)
    want = jax.tree_util.tree_map(np.asarray, j_init_mngp(
        jax.random.PRNGKey(0), CFG))
    assert (jax.tree_util.tree_structure(ck["params"])
            == jax.tree_util.tree_structure(want))
    for a, b in zip(tree_leaves(bundle), jax.tree_util.tree_leaves(
            {"model": ck["params"], "gate": ck["gate_params"]})):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), ck["model_state"][k])
    assert set(ck["model_state"]) == set(j_init_state(CFG))
    mu = jax.tree_util.tree_leaves(ck["opt_state"]["mu"])
    assert int(ck["opt_state"]["count"]) == 1
    for p, m in zip(tree_leaves(bundle), mu):
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), m)


def test_slim_extract_and_load_weights_into_equal_jax(jax_ckpt, tmp_path):
    path = jax_ckpt[0]
    js, ts = jck.slim_ckpt(path), tck.slim_ckpt(path)
    assert set(js) == set(ts) == {"params", "gate_params", "step",
                                  "hparams"}
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(ts)):
        np.testing.assert_array_equal(a, b)
    ck = tck.load_ckpt(path)
    for prune in ((), ("geo", "rgb")):
        want = jck.extract_model_state_dict(ck, "params", prune)
        got = tck.extract_model_state_dict(ck, "params", prune)
        assert set(got) == set(want)
    slim = str(tmp_path / "epoch=0_slim.ckpt")
    tck.save_ckpt(slim, ts)
    fresh = j_init_mngp(jax.random.PRNGKey(9), CFG)
    # one leaf of another shape is skipped by both
    fresh["geo"]["w"][0] = jnp.zeros((3, 3))
    for src in (path, slim):
        want = jck.load_weights_into(fresh, src)
        got = tck.load_weights_into(
            convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, fresh), device="cpu")[0],
            src)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tck.load_weights_into(fresh, None) is fresh


def test_failed_save_leaves_nothing_at_the_path(tmp_path, monkeypatch):
    path = str(tmp_path / "epoch=3.ckpt")

    def dump(obj, f, protocol):
        f.write(b"\x80\x04partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(tck.pickle, "dump", dump)
    with pytest.raises(KeyboardInterrupt):
        tck.save_ckpt(path, {"step": 3})
    assert os.listdir(tmp_path) == []
    monkeypatch.undo()
    tck.save_ckpt(path, {"step": 3})
    assert tck.load_ckpt(path) == {"step": 3}


def test_load_ckpt_refuses_foreign_classes_and_orbax_dirs(tmp_path):
    path = str(tmp_path / "x.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"x": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tck.load_ckpt(path)
    with pytest.raises(NotImplementedError, match="orbax"):
        tck.load_ckpt(str(tmp_path))
