"""Parameters and state between the JAX package and the port.

The JAX pytrees of `init_mngp`, `init_ray_gate` and `init_mngp_state`
(dicts and lists of arrays), given as numpy arrays, become the same
structure of torch tensors, and back. Layouts are unchanged (weights
(in, out), stacked experts on a leading K axis, the (L, T, 2) f32 hash
table, (K, C, G, G, G) bool occupancy), and every value is carried bit for
bit, so a table trained by either package decodes the same in the other.

The Adam state: optax's `ScaleByAdamState(count, mu, nu)` (mu and nu in
the tree layout of the trained bundle {"model", "gate"}) is
`torch.optim.Adam`'s `step`, `exp_avg` and `exp_avg_sq`, per leaf in
`tree_leaves` order; `ScaleByScheduleState.count` is the trainer's
global step. The port writes the Adam state as a plain
{"count", "mu", "nu"} dict in that layout.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE
from .parallel.step import tree_leaves, tree_unflatten


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def params_from_jax(params_np: dict, gate_np: dict | None = None,
                    device=DEFAULT_DEVICE):
    """(model params, gate params) as numpy pytrees -> torch dicts."""
    gate = None if gate_np is None else _to_torch(gate_np, device)
    return _to_torch(params_np, device), gate


def state_from_jax(state_np: dict, device=DEFAULT_DEVICE) -> dict:
    """Model state (density grids, occupancy, bbox) -> torch dict."""
    return _to_torch(state_np, device)


def params_to_jax(params: dict, gate: dict | None = None):
    """Inverse of params_from_jax: numpy pytrees for `jnp.asarray`."""
    return _to_numpy(params), None if gate is None else _to_numpy(gate)


def state_to_jax(state: dict) -> dict:
    """Inverse of state_from_jax."""
    return _to_numpy(state)


def adam_state_to_jax(optimizer: torch.optim.Adam, bundle: dict) -> dict:
    """{"count", "mu", "nu"} of an Adam over tree_leaves(bundle): numpy
    trees in the bundle's layout (zeros for a leaf not yet stepped)."""
    count, mu, nu = 0, [], []
    for p in tree_leaves(bundle):
        st = optimizer.state.get(p)
        if st:
            count = int(st["step"])
            mu.append(st["exp_avg"])
            nu.append(st["exp_avg_sq"])
        else:
            mu.append(torch.zeros_like(p))
            nu.append(torch.zeros_like(p))
    return {"count": np.int32(count),
            "mu": _to_numpy(tree_unflatten(bundle, mu)),
            "nu": _to_numpy(tree_unflatten(bundle, nu))}


def adam_state_from_jax(opt_state) -> dict:
    """The Adam state of a checkpoint of either package: optax's
    (ScaleByAdamState, ScaleByScheduleState) tuple (EmptyState for a
    constant learning rate), or the port's dict. Returns {"count", "mu",
    "nu"} and, from an optax schedule, "schedule_count".
    Raises ValueError on any other layout (for example optax's
    multi_transform of --optimize_ext)."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= set(opt_state):
        return {k: opt_state[k] for k in ("count", "mu", "nu")}
    if (isinstance(opt_state, (list, tuple)) and len(opt_state) == 2
            and all(hasattr(s, "_fields") for s in opt_state)
            and opt_state[0]._fields == ("count", "mu", "nu")
            and opt_state[1]._fields in (("count",), ())):
        adam, lr_state = opt_state     # a schedule's count, or a constant
        out = {"count": adam.count, "mu": adam.mu, "nu": adam.nu}
        if lr_state._fields:
            out["schedule_count"] = lr_state.count
        return out
    raise ValueError("not an Adam state of either package")


def load_adam_state(optimizer: torch.optim.Adam, bundle: dict,
                    state: dict) -> None:
    """Set the Adam over tree_leaves(bundle) to `state` (as
    adam_state_from_jax returns it). Raises ValueError, changing
    nothing, when its leaves do not match the bundle's in number and
    shape."""
    leaves = tree_leaves(bundle)
    mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    if not (len(mu) == len(nu) == len(leaves) and all(
            tuple(np.shape(m)) == tuple(p.shape) == tuple(np.shape(v))
            for p, m, v in zip(leaves, mu, nu))):
        raise ValueError("the Adam state does not match the parameters")
    step = float(np.asarray(state["count"]))
    for p, m, v in zip(leaves, mu, nu):
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(m, np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(
                np.array(v, np.float32)).to(p.device),
        }
