"""PyTorch port vs the JAX package, marching: MarchConfig, the sample
lattice, the multi-cascade occupancy cell, the candidate occupancy (the
CUDA kernel's plain twin on the CPU) against the reference's Pallas
brick-extract path, and march_rays_test_flat. All exact: positions,
occupancy bits and the compacted march must equal the jitted reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import marching as jm
from radnerf_tpu_torch.ops import marching as tm

torch.set_num_threads(1)


def _cfgs(**kw):
    return jm.MarchConfig(**kw), tm.MarchConfig(**kw)


@pytest.mark.parametrize("kw", [
    {}, {"scale": 0.5, "grid_size": 32},
    {"scale": 2.0, "cascades": 3, "exp_step_factor": 1 / 256},
    {"scale": 8.0, "cascades": 5, "exp_step_factor": 1 / 256,
     "max_samples": 512},
])
def test_march_config_properties(kw):
    jc, tc = _cfgs(**kw)
    assert (tc.dt_min, tc.dt_max, tc.k_candidates) == (
        jc.dt_min, jc.dt_max, jc.k_candidates)


def test_sample_lattice_exact_linear_and_close_exponential():
    rng = np.random.default_rng(0)
    t0 = rng.uniform(-1, 3, (300, 1)).astype(np.float32)
    k = np.arange(512, dtype=np.int32)[None, :]      # one k_block
    jc, tc = _cfgs()
    ref = jax.jit(lambda a, b: jm.sample_lattice(a, b, jc))(t0, k)
    got = tm.sample_lattice(torch.from_numpy(t0), torch.from_numpy(k), tc)
    # t0 + k * dt_min as one fused multiply-add, as XLA contracts it in
    # its vectorized loop (a row length that leaves a scalar remainder,
    # unlike the render's k_block of 512, is computed unfused there)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jc, tc = _cfgs(scale=8.0, cascades=5, exp_step_factor=1 / 256)
    ref = jax.jit(lambda a, b: jm.sample_lattice(a, b, jc))(t0, k)
    got = tm.sample_lattice(torch.from_numpy(t0), torch.from_numpy(k), tc)
    # the geometric phase goes through exp, which XLA and PyTorch round
    # differently by an ulp or two
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("kw", [{"grid_size": 64},
                                {"scale": 4.0, "cascades": 4,
                                 "grid_size": 32,
                                 "exp_step_factor": 1 / 256}])
def test_occ_mip_cell_exact(kw):
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(4000, 3)) * kw.get("scale", 0.5)
           ).astype(np.float32)
    dt = np.exp(rng.uniform(-8, 0, 4000)).astype(np.float32)
    xyz[:4] = [[0, 0, 0], [0.5, -0.5, 0.25], [1e-8, 0, 0], [-3, 2, 9]]
    mip, n = jax.jit(lambda a, b: jm._occ_mip_cell(a, b, jc))(xyz, dt)
    tmip, tn = tm._occ_mip_cell(torch.from_numpy(xyz), torch.from_numpy(dt),
                                tc)
    np.testing.assert_array_equal(tmip.numpy(), np.asarray(mip))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n))
    if tc.cascades > 1:
        assert len(np.unique(np.asarray(mip))) > 1


def _stream(cfg, N, K, seed=3, occ_p=0.3):
    """Ray-ordered dt_min candidates (the reference suite's stream)."""
    rng = np.random.default_rng(seed)
    G = cfg.grid_size
    occ = rng.random((cfg.cascades, G, G, G)) < occ_p
    o = rng.normal(size=(N, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    t = 0.7 + np.arange(K) * cfg.dt_min
    xyz = (o[:, None, :] + t[None, :, None] * d[:, None, :]).astype(
        np.float32)
    return occ, xyz, np.full((N, K), cfg.dt_min, np.float32)


def _random_points(cfg, N, K, seed=11):
    rng = np.random.default_rng(seed)
    occ = rng.random((1, cfg.grid_size, cfg.grid_size, cfg.grid_size)) < 0.3
    xyz = rng.uniform(-0.45, 0.45, size=(N, K, 3)).astype(np.float32)
    return occ, xyz, np.full((N, K), cfg.dt_min, np.float32)


@pytest.mark.parametrize("make", [_stream, _random_points])
def test_occupancy_lookup_bricks_equals_jax(make):
    """N=32, K=256: N*K/256 = 32 brick blocks, a multiple of the Pallas
    grid step, so the reference takes its extract kernel (the stream) or
    its exact run-cap fallback (random points)."""
    jc, tc = _cfgs(scale=0.5, cascades=1, grid_size=64)
    occ, xyz, dt = make(jc, 32, 256)
    assert (32 * 256 // jm.OCC_BLOCK) % jm.OCC_GBLK == 0
    ref = jax.jit(lambda a, b, c: jm.occupancy_lookup_bricks(a, b, c, jc))(
        xyz, dt, occ)
    got = tm.occupancy_lookup_bricks(*map(torch.from_numpy, (xyz, dt, occ)),
                                     tc)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.float().mean() < 1


def test_pack_occ_bricks_equals_jax():
    occ = np.random.default_rng(5).random((2, 16, 16, 16)) < 0.5
    ref = np.asarray(jm.pack_occ_bricks(jnp.asarray(occ)), np.float32)
    got = tm.pack_occ_bricks(torch.from_numpy(occ)).float().numpy()
    np.testing.assert_array_equal(got, ref)


def _march_setup(seed=0, n=64, g=32):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * 0.2
    d[:5] = -d[:5]                       # pointing away: miss the box
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    occ = (np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3)[None]
    occ = occ & (rng.random(occ.shape) < 0.8)
    return o.astype(np.float32), d.astype(np.float32), occ


MARCH_KEYS = ("ts", "deltas", "ray_id", "valid", "offsets", "cap",
              "n_samples", "total", "new_cursor", "kept", "consumed")


@pytest.mark.parametrize("budget,cap", [(24, 128), (4, 32)])
def test_march_rays_test_flat_equals_jax(budget, cap):
    """Two resumed iterations, with dead rays, rays that miss, and (budget
    4) a saturated buffer whose proportional caps truncate rays."""
    from radnerf_tpu.ops.intersection import scene_near_far

    jc, tc = _cfgs(scale=0.5, grid_size=32)
    o, d, occ = _march_setup()
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    t1, t2 = (np.asarray(a) for a in jax.jit(scene_near_far)(o, d, c, h))
    alive = (t1 >= 0) & (np.arange(64) % 7 != 3)
    assert (t1 < 0).any()

    jf = jax.jit(lambda cur, al: jm.march_rays_test_flat(
        o, d, cur, t2, occ, jc, al, k_block=512, cap_per_ray=cap,
        budget_per_ray=budget))
    to = lambda a: torch.tensor(np.asarray(a))
    cur_j, cur_t = t1, to(t1)
    full = []
    for _ in range(2):
        ref = jf(cur_j, alive)
        got = tm.march_rays_test_flat(
            to(o), to(d), cur_t, to(t2), to(occ), tc, to(alive),
            k_block=512, cap_per_ray=cap, budget_per_ray=budget)
        for key in MARCH_KEYS:
            np.testing.assert_array_equal(
                got[key].numpy(), np.asarray(ref[key]), err_msg=key)
        assert int(got["total"]) > 0
        want = got["kept"].clamp_max(cap)      # per-ray share if unlimited
        full.append(bool((got["cap"] < want).any()))
        cur_j, cur_t = ref["new_cursor"], got["new_cursor"]
    assert any(full)        # the global budget truncated some rays


def test_compact_flat_keeps_front_of_each_ray():
    """Port-only structure check of the compaction on a hand-made keep
    mask: slot s of ray r holds its s-th kept candidate."""
    cfg = dataclasses.replace(tm.MarchConfig(), samples_per_ray=3)
    keep = torch.tensor([[0, 1, 1, 0, 1, 1], [0, 0, 0, 0, 0, 0],
                         [1, 0, 0, 0, 0, 1]], dtype=torch.bool)
    t = torch.arange(18, dtype=torch.float32).reshape(3, 6)
    m, flat = tm._compact_flat_from_keep(t, t, keep, cfg, budget_per_ray=2)
    assert m["cap"].tolist() == [3, 0, 2]
    assert m["offsets"].tolist() == [0, 3, 3]
    assert m["ts"].tolist() == [1.0, 2.0, 4.0, 12.0, 17.0, 0.0]
    assert m["ray_id"].tolist() == [0, 0, 0, 2, 2, 2]
    assert m["valid"].tolist() == [True] * 5 + [False]
    assert flat[:5].tolist() == [1, 2, 4, 12, 17]
