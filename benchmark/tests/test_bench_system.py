"""The harness builds each training cell's Trainer as the program's own
system does from the same flags: the same field and training options,
hooks, mesh size, parameter tree and state. The harness hands it the
benchmark's scene and weights instead of a dataset read from disk, so
it does not go through the system's `configure_model`; this test fails
where the two ways of building drift apart."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from tiny import SPEC, TRAIN, run

SYSTEMS = {"rad_moe": "NeRFSystem", "switch": "OtherNeRFSystem"}


class Recorder:
    """Stands in for the program's Trainer: keeps its arguments."""

    calls: list = []

    def __init__(self, cfg, tcfg, params, gate_params, model_state, data,
                 gen, ext_params=None, loss=None, density_fn=None,
                 mesh=None):
        Recorder.calls.append(dict(
            cfg=cfg, tcfg=tcfg, params=params, gate_params=gate_params,
            model_state=model_state, data=data, gen=gen,
            ext_params=ext_params, loss=loss, density_fn=density_fn,
            mesh=mesh))


def _shapes(tree) -> dict:
    from radnerf_tpu_torch.parallel.step import tree_leaves, tree_paths

    if tree is None:
        return {}
    return {k: (tuple(v.shape), v.dtype)
            for k, v in zip(tree_paths(tree), tree_leaves(tree))}


def _hook(fn):
    return None if fn is None else (fn.__module__, fn.__qualname__)


def _summary(call: dict) -> dict:
    state = {k: (tuple(v.shape), v.dtype)
             for k, v in call["model_state"].items()}
    return {"cfg": call["cfg"], "tcfg": call["tcfg"],
            "params": _shapes(call["params"]),
            "gate": _shapes(call["gate_params"]), "state": state,
            "data": sorted(call["data"]), "ext": call["ext_params"],
            "loss": _hook(call["loss"]),
            "density_fn": _hook(call["density_fn"]),
            "mesh": call["mesh"].size, "gen": call["gen"].device.type}


@pytest.mark.parametrize("name", TRAIN)
def test_the_harness_builds_the_systems_trainer(name, monkeypatch,
                                                tmp_path):
    import radnerf_tpu_torch.train.other_trainer as other
    import radnerf_tpu_torch.train.trainer as trainer_mod

    from benchmark.drivers import common
    from benchmark.reference.scene import make_weights
    from benchmark.systems.common import parse_flags

    monkeypatch.chdir(tmp_path)               # the system writes its logs
    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    cell = run.find_cell(SPEC, name)
    conf, traffic = cell["config"], cell["traffic"]
    flags = conf["flags"] + traffic["flags"] + cell["cell"]["flags"]
    cpu = torch.device("cpu")
    Recorder.calls = []

    # the program's way: its system class, its configure_model
    h = parse_flags(flags)
    cls = getattr(other if conf["system"] == "switch" else trainer_mod,
                  SYSTEMS[conf["system"]])
    system = cls(h, device="cpu")
    system.train_dataset = types.SimpleNamespace(
        STEPS_PER_EPOCH=1000, rays=np.zeros((2, 12, 3), np.float32),
        poses=np.zeros((2, 3, 4), np.float32),
        directions=np.ones((12, 3), np.float32))
    system.tcfg = system.train_config()
    system.configure_model()

    # the harness's way
    scene = {"images": torch.zeros(2, 12, 3), "poses": torch.zeros(2, 3, 4),
             "directions": torch.ones(12, 3)}
    weights = make_weights(common.reference(conf).param_spec(conf["model"]),
                           7, cpu)
    common.system(conf).build_trainer(flags, conf["model"], scene, weights,
                                      11, cpu)

    program, harness = (_summary(c) for c in Recorder.calls)
    assert harness == program
