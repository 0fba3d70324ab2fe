"""Checkpoint save / load / slim (twin of radnerf_tpu/utils/ckpt.py).

A checkpoint is one pickle file of numpy arrays and plain Python values,
in the JAX package's tree layout (`convert.params_to_jax`,
`convert.state_to_jax`), so either package loads the other's:
{params, gate_params, opt_state, model_state, step, hparams}, and
ext_params with --optimize_ext. The port writes its Adam state as a
plain {"count", "mu", "nu"} dict, one per group with --optimize_ext
(`convert.adam_state_to_jax`); the JAX package writes optax's
(ScaleByAdamState, ScaleByScheduleState) NamedTuples, and with
--optimize_ext multi_transform's PartitionState of MaskedStates (with
MaskedNode leaves), which `load_ckpt` reads as stand-ins of the same
names and fields, without importing optax.

`load_ckpt` unpickles only numpy arrays, dtypes and those stand-ins, and
refuses any other class a file names.

--ckpt_backend orbax: the reference writes an orbax directory from
orbax's background thread, so that training never waits on
serialization. The port has no orbax (nor has the card's machine) and
writes the same single-file pickle at the same path from a thread of its
own (`AsyncCkptWriter`): the values are copied to the host first, one
write is in flight at a time. An orbax directory of the JAX package is
not read: `load_ckpt` raises, naming orbax.
"""

from __future__ import annotations

import collections
import os
import pickle
import threading
from typing import Any

import numpy as np
import torch

# stand-ins for the optax states a JAX checkpoint pickles by name
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          "count mu nu")
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState",
                                              "count")
EmptyState = collections.namedtuple("EmptyState", "")
PartitionState = collections.namedtuple("PartitionState", "inner_states")
MaskedState = collections.namedtuple("MaskedState", "inner_state")
MaskedNode = collections.namedtuple("MaskedNode", "")
_OPTAX = {c.__name__: c for c in (ScaleByAdamState, ScaleByScheduleState,
                                  EmptyState, PartitionState, MaskedState,
                                  MaskedNode)}
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "optax" and name in _OPTAX:
            return _OPTAX[name]
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        raise pickle.UnpicklingError(
            f"a checkpoint holds numpy arrays and plain values; this one "
            f"names {module}.{name}")


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_ckpt(path: str, payload: dict) -> None:
    """Write a single-file pickle checkpoint ATOMICALLY (a temporary file,
    fsync, os.replace): a failed or interrupted save leaves nothing at
    `path`, so --resume auto may trust any file it finds there. Tensors
    become numpy arrays, tuples lists."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_to_numpy(payload), f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _host_copy(tree: Any) -> Any:
    """`tree` with every tensor and numpy array copied to new host arrays
    (a CPU tensor's .numpy() shares its memory, which the next step
    changes), tuples as lists, as save_ckpt pickles them."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCkptWriter:
    """Checkpoints written by a background thread (--ckpt_backend orbax):
    `save` copies the payload to the host, waits for the write before it
    (one write in flight) and returns while a thread writes the file with
    save_ckpt (temporary file, fsync, rename). `wait` returns once no
    write is in flight, re-raising the error of a write that failed."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _write(self, path: str, payload: dict) -> None:
        try:
            save_ckpt(path, payload)
        except Exception as e:         # re-raised by the next wait()
            self._error = e

    def save(self, path: str, payload: dict) -> None:
        host = _host_copy(payload)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(path, host), name="ckpt-writer",
            daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_ckpt(path: str) -> dict:
    """A checkpoint of either package (see the module docstring)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory, which needs orbax "
            "to read; the port reads single-file pickle checkpoints only "
            "(its --ckpt_backend orbax writes one in the background)")
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def extract_model_state_dict(
    ckpt: dict, model_name: str = "params", prune: tuple = ()
) -> dict:
    """Prefix-scoped extraction (utils/util.py:8-23): pull one submodule's
    tree out of a full checkpoint, dropping pruned keys."""
    sub = ckpt[model_name]
    if prune:
        sub = {k: v for k, v in sub.items() if k not in prune}
    return sub


def load_weights_into(params: dict, path: str, model_name: str = "params"):
    """Partial warm start (utils/util.py:25-30): the leaves of `params`
    (a tree of tensors) replaced by the checkpoint's where the path and
    shape match (on the leaf's device, in the checkpoint's dtype);
    mismatches are skipped silently."""
    if not path:
        return params
    ckpt = load_ckpt(path)
    src = ckpt.get(model_name, ckpt)

    def merge(dst, s):
        if isinstance(dst, dict) and isinstance(s, dict):
            return {
                k: merge(dst[k], s[k]) if k in s else dst[k] for k in dst
            }
        if isinstance(dst, list) and isinstance(s, list):
            return [merge(d, x) for d, x in zip(dst, s)]
        if (isinstance(s, np.ndarray)
                and tuple(dst.shape) == tuple(s.shape)):
            return torch.from_numpy(np.array(s)).to(dst.device)
        return dst

    return merge(params, src)


def slim_ckpt(path: str, save_poses: bool = False) -> dict:
    """Drop optimizer state, density grids and buffers; keep params (and
    optionally optimized poses) — utils/util.py:33-43."""
    ckpt = load_ckpt(path)
    keep = {"params": ckpt["params"], "step": ckpt.get("step")}
    if "gate_params" in ckpt:
        keep["gate_params"] = ckpt["gate_params"]
    if save_poses and "pose_params" in ckpt:
        keep["pose_params"] = ckpt["pose_params"]
    if "hparams" in ckpt:
        keep["hparams"] = ckpt["hparams"]
    return keep
