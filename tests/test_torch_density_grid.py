"""PyTorch port vs the JAX package, the occupancy-grid update: cell
coordinates and positions, the cell sampler, `update_density_grid`
through `mngp_update_density_grids` (warmup: every cell; and a later
update: G^3/4 uniform + G^3/4 occupied cells, drawn with replacement), at
`__graft_entry__._tiny_setup`'s size with hash_impl brick3. The JAX key's
draws are computed here and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import ngp as jngp
from radnerf_tpu.models.mngp import MNGPConfig as JCfg
from radnerf_tpu.models.mngp import init_mngp as j_init_mngp
from radnerf_tpu.models.mngp import init_mngp_state as j_init_state
from radnerf_tpu.models.mngp import (
    mngp_update_density_grids as j_update_grids,
)
from radnerf_tpu_torch.convert import params_from_jax, state_from_jax
from radnerf_tpu_torch.models import ngp as tngp
from radnerf_tpu_torch.models.mngp import MNGPConfig
from radnerf_tpu_torch.models.mngp import mngp_update_density_grids

torch.set_num_threads(1)

CFG_KW = dict(scale=0.5, grid_size=16, n_levels=4, log2_T=10, n_experts=2,
              compute_dtype="bfloat16", hash_impl="brick3")
THRESH = 0.01 * 1024 / np.sqrt(3)     # the trainer's DENSITY_THRESHOLD


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    cfg = JCfg(**CFG_KW)
    params = j_init_mngp(jax.random.PRNGKey(0), cfg)
    # a table with structure, so that the densities (and occupancy) vary
    rng = np.random.default_rng(0)
    params["hash_table"] = jnp.asarray(rng.uniform(
        -1, 1, params["hash_table"].shape).astype(np.float32))
    state = j_init_state(cfg)
    tp, _ = params_from_jax(_np(params), device="cpu")
    return cfg, params, state, tp


def _jax_draws(key, grid, cfg, warmup):
    """The draws `mngp_update_density_grids` takes from `key`, per expert
    and cascade, in the port's `draws` format."""
    K, C, G = cfg.n_experts, cfg.cascades, cfg.grid_size
    M, n_cells = G**3 // 4, G**3
    out = []
    for k, key_k in enumerate(jax.random.split(key, K)):
        keys = jax.random.split(key_k, 2 * C)
        per_c = []
        for c in range(C):
            d = {}
            if not warmup:
                k1, k2, k3 = jax.random.split(keys[2 * c + 1], 3)
                total = int((np.asarray(grid)[k, c] > THRESH).sum())
                d["uniform"] = jax.random.randint(k1, (M,), 0, n_cells)
                d["occ_rank"] = jax.random.randint(k2, (M,), 0,
                                                   max(total, 1))
                d["fallback"] = jax.random.randint(k3, (M,), 0, n_cells)
            n = n_cells if warmup else 2 * M
            d["jitter"] = jax.random.uniform(keys[2 * c], (n, 3),
                                             minval=-1.0, maxval=1.0)
            per_c.append({a: torch.from_numpy(np.array(v))
                          for a, v in d.items()})
        out.append(per_c)
    return out


def _density_tol(ref):
    """Densities are exp of a bf16 MLP output h: an h one bf16 ulp apart
    (2^-8 of |h|, from f32 sums in another order, or a cell position one
    f32 ulp apart where XLA did not fuse a multiply-add) moves the density
    by a factor exp(|h| 2^-8); allow two ulps."""
    h = np.abs(np.log(np.maximum(ref, 1e-30)))
    return ref * np.expm1(2 * 2.0**-8 * np.maximum(h, 1.0))


def test_cell_coords_and_positions_match_jax():
    jc, tc = JCfg(**CFG_KW), MNGPConfig(**CFG_KW)
    coords = jngp.all_cell_coords(jc)
    got = tngp.all_cell_coords(tc, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(coords))
    np.testing.assert_array_equal(
        tngp.coords_to_flat(got, 16).numpy(),
        np.asarray(jngp.coords_to_flat(coords, 16)))
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda c, k: jngp.cell_world_positions(
        c, 0, jc, k))(coords, key))
    jit = jax.random.uniform(key, coords.shape, minval=-1.0, maxval=1.0)
    pos = tngp.cell_world_positions(got, 0, tc,
                                    jitter=torch.from_numpy(np.array(jit)))
    # XLA rewrites (c / (G - 1) * 2 - 1) * (s - half) in its own way
    # (constant folding, fused multiply-adds in vectorized loops only):
    # two roundings of intermediates of magnitude <= 1 apart
    assert (np.abs(pos.numpy() - ref) <= 2 * np.spacing(np.float32(1.0))
            ).all()
    assert (pos.numpy() == ref).mean() > 0.3
    assert np.abs(ref).max() <= 0.5


def test_sample_cells_equals_jax_with_the_same_draws():
    rng = np.random.default_rng(1)
    grid = np.where(rng.random(4096) < 0.2, rng.uniform(0, 20, 4096),
                    0.0).astype(np.float32)
    for g in (grid, np.zeros_like(grid)):         # occupied, and none
        key = jax.random.PRNGKey(7)
        ref = np.asarray(jax.jit(lambda k, v: jngp._sample_cells(
            k, v, 1024, THRESH, 16))(key, g))
        k1, k2, k3 = jax.random.split(key, 3)
        total = int((g > THRESH).sum())
        draws = {"uniform": jax.random.randint(k1, (1024,), 0, 4096),
                 "occ_rank": jax.random.randint(k2, (1024,), 0,
                                                max(total, 1)),
                 "fallback": jax.random.randint(k3, (1024,), 0, 4096)}
        got = tngp._sample_cells(
            None, torch.from_numpy(g), 1024, THRESH, 16,
            {a: torch.from_numpy(np.array(v)) for a, v in draws.items()})
        np.testing.assert_array_equal(got.numpy(), ref)
        if total:
            assert (g[got.numpy()[1024:]] > THRESH).all()
    gen = torch.Generator().manual_seed(0)
    drawn = tngp._sample_cells(gen, torch.from_numpy(grid), 1024, THRESH, 16)
    assert drawn.shape == (2048,) and (grid[drawn.numpy()[1024:]] >
                                       THRESH).all()


def test_warmup_update_matches_jax(models):
    cfg, params, state, tp = models
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda p, s, k: j_update_grids(p, s, cfg, k, THRESH,
                                                 True))(params, state, key)
    tcfg = MNGPConfig(**CFG_KW)
    ts = state_from_jax(_np(state), device="cpu")
    got = mngp_update_density_grids(
        tp, ts, tcfg, None, THRESH, True,
        draws=_jax_draws(key, state["density_grid"], cfg, True))
    rg, gg = np.asarray(ref["density_grid"]), got["density_grid"].numpy()
    assert (np.abs(gg - rg) <= _density_tol(rg)).all()
    assert (gg == rg).mean() > 0.8
    # occupancy: equal wherever the density is not within tolerance of
    # the threshold
    pos = rg > 0
    thr = min(rg[pos].mean(), THRESH)
    ro, go = np.asarray(ref["occ"]), got["occ"].numpy()
    clear = (np.abs(rg - thr) > _density_tol(rg)).reshape(ro.shape)
    np.testing.assert_array_equal(go[clear], ro[clear])
    assert 0.05 < go.mean() < 0.95


def test_later_update_matches_jax_on_cells_drawn_once(models):
    cfg, params, _, tp = models
    warm = jax.jit(lambda p, s, k: j_update_grids(
        p, s, cfg, k, THRESH, True))(params, j_init_state(cfg),
                                     jax.random.PRNGKey(12))
    key = jax.random.PRNGKey(13)
    ref = jax.jit(lambda p, s, k: j_update_grids(p, s, cfg, k, THRESH,
                                                 False))(params, warm, key)
    tcfg = MNGPConfig(**CFG_KW)
    ts = state_from_jax(_np(warm), device="cpu")
    draws = _jax_draws(key, warm["density_grid"], cfg, False)
    got = mngp_update_density_grids(tp, ts, tcfg, None, THRESH, False,
                                    draws=draws)
    rg, gg = np.asarray(ref["density_grid"]), got["density_grid"].numpy()
    for k in range(cfg.n_experts):
        flat = tngp._sample_cells(None, ts["density_grid"][k, 0], 1024,
                                  THRESH, 16, draws[k][0]).numpy()
        times = np.bincount(flat, minlength=4096)
        once, never = times == 1, times == 0
        assert once.sum() > 500 and (times > 1).any()
        # never drawn: max(grid * 0.95, 0), the same f32 product
        np.testing.assert_array_equal(gg[k, 0][never], rg[k, 0][never])
        # drawn once: max(grid * 0.95, density at the jittered position);
        # a cell drawn twice keeps one of its draws, which one is not fixed
        assert (np.abs(gg[k, 0][once] - rg[k, 0][once])
                <= _density_tol(rg[k, 0][once])).all()
    assert got["occ"].shape == (2, 1, 16, 16, 16)


def test_update_draws_from_a_generator():
    cfg = MNGPConfig(**CFG_KW)
    gen = torch.Generator().manual_seed(0)
    from radnerf_tpu_torch.models.mngp import init_mngp, init_mngp_state
    params = init_mngp(gen, cfg, device="cpu")
    with torch.no_grad():
        params["hash_table"].uniform_(-1, 1, generator=gen)
    state = init_mngp_state(cfg, device="cpu")
    for warmup in (True, False, False):
        state = mngp_update_density_grids(params, state, cfg, gen, THRESH,
                                          warmup)
        assert torch.isfinite(state["density_grid"]).all()
    assert 0.0 < float(state["occ"].float().mean()) < 1.0
