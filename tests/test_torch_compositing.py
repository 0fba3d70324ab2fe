"""PyTorch port vs the JAX package, flat-layout compositing: segmented
scans (blocked and doubling formulations) and the resumable test-time
compositor, for one expert and with a leading expert axis, given the same
sigmas, rgbs, flat layout and carry."""

import jax
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import compositing as jc
from radnerf_tpu_torch.ops import compositing as tc

torch.set_num_threads(1)


def _segments(B, seed, p=0.05):
    rng = np.random.default_rng(seed)
    seg = rng.random(B) < p
    seg[0] = True
    return seg


@pytest.mark.parametrize("B,C", [(300, 0), (1536, 0), (1536, 3), (2000, 5)])
def test_segmented_cumsum_matches_jax_and_float64(B, C):
    """B <= 512 takes the doubling scan, larger B the blocked matmul form
    (with a ragged last block at B = 2000)."""
    rng = np.random.default_rng(B + C)
    shape = (B,) if C == 0 else (B, C)
    v = np.exp(rng.normal(size=shape) * 2).astype(np.float32)
    seg = _segments(B, C)
    ref = np.asarray(jax.jit(jc.segmented_cumsum)(v, seg))
    got = tc.segmented_cumsum(torch.from_numpy(v), torch.from_numpy(seg))
    # exact per-segment sums in float64, as the ground truth
    sid = np.cumsum(seg) - 1
    exact = np.zeros(shape)
    run = np.zeros(shape[1:])
    for i in range(B):
        run = v[i].astype(np.float64) if seg[i] else run + v[i]
        exact[i] = run
    # float32 sums of <= ~100 positive terms in different orders
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=4e-6)
    assert len(np.unique(sid)) > 10


def test_segmented_cummax_exact():
    rng = np.random.default_rng(0)
    v = rng.normal(size=1800).astype(np.float32)
    seg = _segments(1800, 1)
    ref = np.asarray(jax.jit(jc.segmented_cummax)(v, seg))
    got = tc.segmented_cummax(torch.from_numpy(v), torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), ref)


def _flat_block(N=40, B=1200, E=2, seed=0):
    """A flat layout with truncated, empty and spilled rays, plus the
    per-expert sigmas, rgbs, membership and carry."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(0, 75, N).astype(np.int32)
    cap[3] = 0
    bounds = np.cumsum(cap)
    offsets = (bounds - cap).astype(np.int32)
    starts = np.zeros(B + 1, np.int32)
    np.add.at(starts, np.minimum(offsets, B), 1)
    ray_id = np.clip(np.cumsum(starts[:B]) - 1, 0, N - 1).astype(np.int32)
    valid = np.arange(B) < min(bounds[-1], B)
    assert bounds[-1] > B                       # last rays spill past B
    deltas = np.where(valid, np.float32(np.sqrt(3) / 1024), 0).astype(
        np.float32)
    ts = np.where(valid, rng.uniform(0.2, 1.5, B), 0).astype(np.float32)
    sig = np.exp(rng.normal(3.0, 2.0, (E, B))).astype(np.float32)
    rgb = rng.uniform(0, 1, (E, B, 3)).astype(np.float32)
    member = (rng.random((E, B)) < 0.7) & valid
    acc = {
        "opacity": rng.uniform(0, 0.5, (E, N)).astype(np.float32),
        "depth": rng.uniform(0, 1, (E, N)).astype(np.float32),
        "rgb": rng.uniform(0, 0.5, (E, N, 3)).astype(np.float32),
        "transmittance": rng.uniform(2e-4, 1, (E, N)).astype(np.float32),
        "alive": rng.random((E, N)) < 0.85,
    }
    shared = (deltas, ts, ray_id, offsets, cap)
    return sig, rgb, member, acc, shared


def _check(got, ref):
    for k in ("opacity", "depth", "rgb", "transmittance"):
        # float32 segmented sums and exps in another order
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["alive"].numpy(),
                                  np.asarray(ref["alive"]))


def test_composite_test_flat_single_expert_matches_jax():
    sig, rgb, member, acc, shared = _flat_block()
    acc0 = {k: v[0] for k, v in acc.items()}
    ref = jax.jit(lambda s, r, m, a: jc.composite_test_flat(
        s, r, *shared[:2], *shared[2:], m, a))(sig[0], rgb[0], member[0],
                                                acc0)
    t = lambda a: torch.from_numpy(np.asarray(a))
    d, ts, rid, off, cap = map(t, shared)
    got = tc.composite_test_flat(t(sig[0]), t(rgb[0]), d, ts, rid, off,
                                 cap, t(member[0]),
                                 {k: t(v) for k, v in acc0.items()})
    _check(got, ref)
    # the early-stop froze some rays and left others alive
    assert (~got["alive"] & t(acc0["alive"])).any() and got["alive"].any()


def test_composite_test_flat_expert_axis_matches_jax_vmap():
    sig, rgb, member, acc, shared = _flat_block(seed=1)
    ref = jax.jit(jax.vmap(lambda s, r, m, a: jc.composite_test_flat(
        s, r, *shared[:2], *shared[2:], m, a)))(sig, rgb, member, acc)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = tc.composite_test_flat(t(sig), t(rgb), *map(t, shared), t(member),
                                 {k: t(v) for k, v in acc.items()})
    assert got["rgb"].shape == (2, 40, 3)
    _check(got, ref)
