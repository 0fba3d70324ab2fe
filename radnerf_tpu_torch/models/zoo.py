"""NGP_zoo, an ensemble of K complete independent NGPs (twin of
radnerf_tpu/models/zoo.py): each member has its own hash table, geo/rgb
heads and occupancy grid, which is the unshared-encoder MNGP's layout;
only the intent differs (the moe_render zoo path)."""

from __future__ import annotations

from .mngp import (  # noqa: F401
    MNGPConfig,
    init_mngp,
    init_mngp_state,
    mngp_forward_expert,
    mngp_update_density_grids,
)


def NGPZooConfig(**kw) -> MNGPConfig:
    """MNGPConfig with one hash table per member (unless told otherwise)."""
    kw.setdefault("shared_encoder", False)
    return MNGPConfig(**kw)


init_ngp_zoo = init_mngp
init_ngp_zoo_state = init_mngp_state
zoo_forward_model = mngp_forward_expert
zoo_update_density_grids = mngp_update_density_grids
