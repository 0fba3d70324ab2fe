"""Parameters and state between the JAX package and the port.

The JAX pytrees of `init_mngp`, `init_ray_gate` and `init_mngp_state`
(dicts and lists of arrays), given as numpy arrays, become the same
structure of torch tensors, and back. Layouts are unchanged (weights
(in, out), stacked experts on a leading K axis, the (L, T, 2) f32 hash
table, (K, C, G, G, G) bool occupancy), and every value is carried bit for
bit, so a table trained by either package decodes the same in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE


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
