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

With --optimize_ext the bundle also holds "ext", and the reference's
optimizer is `optax.multi_transform({"net": adam, "ext": adam})`, whose
state is `PartitionState(inner_states={"net": MaskedState(...), "ext":
MaskedState(...)})`: each group's Adam over the whole bundle, with
`MaskedNode()` at the other group's leaves. The port reads it as two
groups, {"net": {...}, "ext": {...}}, each with its own count and its
mu and nu over its own leaves, and writes that plain layout.
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


def _groups(bundle: dict) -> dict:
    """The optimizer groups of a bundle: {"net": bundle without "ext",
    "ext": {"ext": ...}} with --optimize_ext, else None."""
    if "ext" not in bundle:
        return None
    return {"net": {k: v for k, v in bundle.items() if k != "ext"},
            "ext": {"ext": bundle["ext"]}}


def adam_state_to_jax(optimizer: torch.optim.Adam, bundle: dict) -> dict:
    """{"count", "mu", "nu"} of an Adam over tree_leaves(bundle): numpy
    trees in the bundle's layout (zeros for a leaf not yet stepped). A
    bundle with "ext" gives {"net": ..., "ext": ...}, one such dict per
    group."""
    groups = _groups(bundle)
    if groups is not None:
        return {k: _adam_group(optimizer, b) for k, b in groups.items()}
    return _adam_group(optimizer, bundle)


def _adam_group(optimizer: torch.optim.Adam, bundle: dict) -> dict:
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


def _unmask(tree):
    """`tree` without its MaskedNode leaves and the containers they empty
    (None where nothing is left)."""
    if type(tree).__name__ == "MaskedNode":
        return None
    if isinstance(tree, dict):
        out = {k: _unmask(v) for k, v in tree.items()}
        out = {k: v for k, v in out.items() if v is not None}
        return out or None
    if isinstance(tree, (list, tuple)):
        out = [v for v in map(_unmask, tree) if v is not None]
        return out or None
    return tree


def adam_state_from_jax(opt_state) -> dict:
    """The Adam state of a checkpoint of either package: optax's
    (ScaleByAdamState, ScaleByScheduleState) tuple (EmptyState for a
    constant learning rate), or the port's dict. Returns {"count", "mu",
    "nu"} and, from an optax schedule, "schedule_count". optax's
    multi_transform state (--optimize_ext), or the port's grouped dict,
    gives {"net": ..., "ext": ...}, one such dict per group.
    Raises ValueError on any other layout."""
    if isinstance(opt_state, dict) and set(opt_state) == {"net", "ext"}:
        return {k: adam_state_from_jax(v) for k, v in opt_state.items()}
    if (hasattr(opt_state, "_fields")
            and opt_state._fields == ("inner_states",)
            and isinstance(opt_state.inner_states, dict)
            and set(opt_state.inner_states) == {"net", "ext"}):
        out = {}
        for k, masked in opt_state.inner_states.items():
            if getattr(masked, "_fields", None) != ("inner_state",):
                raise ValueError("not an Adam state of either package")
            st = adam_state_from_jax(tuple(masked.inner_state))
            out[k] = {**st, "mu": _unmask(st["mu"]), "nu": _unmask(st["nu"])}
        return out
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
    adam_state_from_jax returns it; grouped where the bundle holds
    "ext"). Raises ValueError, changing nothing, when its groups or
    leaves do not match the bundle's in number and shape."""
    groups = _groups(bundle)
    if groups is None:
        if "mu" not in state:
            raise ValueError("the Adam state has groups the bundle lacks")
        pairs = [(bundle, state)]
    else:
        if set(state) != set(groups):
            raise ValueError("the Adam state lacks the bundle's groups")
        pairs = [(groups[k], state[k]) for k in groups]
    updates = {}
    for part, st in pairs:
        leaves = tree_leaves(part)
        mu, nu = tree_leaves(st["mu"]), tree_leaves(st["nu"])
        if not (len(mu) == len(nu) == len(leaves) and all(
                tuple(np.shape(m)) == tuple(p.shape) == tuple(np.shape(v))
                for p, m, v in zip(leaves, mu, nu))):
            raise ValueError("the Adam state does not match the parameters")
        step = float(np.asarray(st["count"]))
        for p, m, v in zip(leaves, mu, nu):
            updates[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.from_numpy(
                    np.array(m, np.float32)).to(p.device),
                "exp_avg_sq": torch.from_numpy(
                    np.array(v, np.float32)).to(p.device),
            }
    optimizer.state.update(updates)
