"""PyTorch port vs the JAX package, the slice as a whole: the Rad-NeRF MoE
test-time render (`ml_render_test`, shared encoder, union sampling, flat
layout, brick3, bf16) at a small size whose shapes reach both Pallas
kernels on the JAX side; the parameter converter; the chunked camera
render; the refusal of the dense layout, not ported yet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models.gates import init_ray_gate as j_init_gate
from radnerf_tpu.models.mngp import MNGPConfig as JCfg
from radnerf_tpu.models.mngp import init_mngp as j_init_mngp
from radnerf_tpu.models.mngp import init_mngp_state as j_init_state
from radnerf_tpu.ops import hashgrid_brick3 as jb3
from radnerf_tpu.ops import marching as jm
from radnerf_tpu.render.ml_render import ml_render_test as j_ml_render_test
from radnerf_tpu.render.render import RenderConfig as JRender
from radnerf_tpu_torch.convert import (
    params_from_jax, params_to_jax, state_from_jax, state_to_jax,
)
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mngp import MNGPConfig, init_mngp
from radnerf_tpu_torch.models.mngp import init_mngp_state
from radnerf_tpu_torch.render.ml_render import (
    get_rays, ml_render_test, render_rays_chunked,
)
from radnerf_tpu_torch.render.render import RenderConfig

torch.set_num_threads(1)

CFG_KW = dict(scale=0.5, grid_size=32, n_levels=4, log2_T=12, n_experts=2,
              compute_dtype="bfloat16", hash_impl="brick3")
N_RAYS = 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _occupancy(g=32):
    """Expert 0: a solid 0.3-radius sphere; expert 1: its +x half."""
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3
    return np.stack([sphere, sphere & (xx > 0)])[:, None]


def _rays(n=N_RAYS, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = JCfg(**CFG_KW)
    params = j_init_mngp(jax.random.PRNGKey(0), cfg)
    gate = j_init_gate(jax.random.PRNGKey(1), cfg.n_experts)
    state = {**j_init_state(cfg), "occ": jnp.asarray(_occupancy())}
    tp, tg = params_from_jax(_np(params), _np(gate), device="cpu")
    ts = state_from_jax(_np(state), device="cpu")
    return (cfg, params, gate, state), (MNGPConfig(**CFG_KW), tp, tg, ts)


def test_shapes_reach_both_pallas_kernels():
    """The reference's static conditions for its two kernels hold at this
    size (the per-block run caps are data-dependent lax.conds on top)."""
    rcfg = JRender()
    mcfg = rcfg.march(JCfg(**CFG_KW))
    # occupancy: N * k_block / 256 brick blocks, a multiple of 32
    assert (N_RAYS * rcfg.test_k_block // jm.OCC_BLOCK) % jm.OCC_GBLK == 0
    assert jm._occ_brick_run_cap(mcfg, jm.OCC_BLOCK) < jm.OCC_BLOCK
    # brick3 'runs': B = N * budget >= 1024 and some level's cap fits
    assert N_RAYS * rcfg.test_budget_per_ray >= jb3.RUN_BLOCK
    caps = [jb3._run_cap(a.res, jb3.RUN_BLOCK)
            for a in jb3.brick3_addrs(JCfg(**CFG_KW).hash)]
    assert min(caps) <= int(jb3.RUN_BLOCK * jb3.RUN_MAX_FRAC)


def test_ml_render_test_matches_jax(models):
    (cfg, params, gate, state), (tcfg, tp, tg, ts) = models
    o, d = _rays()
    ref = jax.jit(lambda p, s, g, ro, rd: j_ml_render_test(
        p, s, cfg, g, ro, rd, rd, JRender()))(params, state, gate, o, d)
    got = ml_render_test(tp, ts, tcfg, tg, *map(torch.from_numpy, (o, d, d)),
                         RenderConfig())
    # the march is exact (test_torch_marching), so both visit the same
    # samples; the hash features agree to one bf16 ulp (the reference's
    # 'runs' kernel rounds its stencil weights through bf16) and the
    # bf16 MLPs to an ulp or two: rgb is a bf16 sigmoid (ulp 2^-8 on
    # [0.5, 1)), sigma = exp(bf16 output) moves opacity and depth far less
    assert int(got["total_samples"]) == int(ref["total_samples"])
    tol = {"rgb": 1e-2, "independent_rgbs": 1e-2, "opacity": 1e-4,
           "depth": 1e-4, "gating_code": 1e-5, "gating_importance": 1e-3}
    for k, atol in tol.items():
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    op = got["opacity"].numpy()
    assert (op > 0.05).mean() > 0.3 and got["iterations"] > 1
    # expert 1 (the half sphere) saw fewer samples than expert 0
    assert float(got["depth"][:, 1].sum()) < float(got["depth"][:, 0].sum())


def test_ml_render_test_dedup_family_matches_jax(models):
    """The same render with hash_impl 'dedup' (the tcnn hash; the port
    packs no brick3 table for it): the reference's dedup forward is XLA
    gathers, the port's a plain gather."""
    (cfg, params, gate, state), (tcfg, tp, tg, ts) = models
    kw = {**CFG_KW, "hash_impl": "dedup"}
    cfg, tcfg = JCfg(**kw), MNGPConfig(**kw)
    o, d = _rays(seed=5)
    ref = jax.jit(lambda p, s, g, ro, rd: j_ml_render_test(
        p, s, cfg, g, ro, rd, rd, JRender()))(params, state, gate, o, d)
    got = ml_render_test(tp, ts, tcfg, tg, *map(torch.from_numpy, (o, d, d)),
                         RenderConfig())
    # the march is exact; the features are equal but for XLA's partial
    # fused multiply-adds of the hash coordinates (an f32 ulp of a
    # position now and then); the bf16 MLPs as above
    assert int(got["total_samples"]) == int(ref["total_samples"])
    tol = {"rgb": 1e-2, "independent_rgbs": 1e-2, "opacity": 1e-4,
           "depth": 1e-4, "gating_code": 1e-5, "gating_importance": 1e-3}
    for k, atol in tol.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert (got["opacity"].numpy() > 0.05).mean() > 0.3


def test_convert_round_trip_is_bitwise(models):
    (cfg, params, gate, state), (tcfg, tp, tg, ts) = models
    back_p, back_g = params_to_jax(tp, tg)
    for a, b in zip(jax.tree_util.tree_leaves(_np((params, gate))),
                    jax.tree_util.tree_leaves((back_p, back_g))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    back_s = state_to_jax(ts)
    assert back_s["occ"].dtype == np.bool_
    for k in state:
        np.testing.assert_array_equal(back_s[k], np.asarray(state[k]))
    assert jax.tree_util.tree_structure(back_p) == \
        jax.tree_util.tree_structure(_np(params))


def test_port_init_has_the_reference_layout():
    jcfg = JCfg(**CFG_KW)
    tcfg = MNGPConfig(**CFG_KW)
    gen = torch.Generator().manual_seed(0)
    tp = init_mngp(gen, tcfg, device="cpu")
    tg = init_ray_gate(gen, tcfg.n_experts, device="cpu")
    ts = init_mngp_state(tcfg, device="cpu")
    jp = j_init_mngp(jax.random.PRNGKey(0), jcfg)
    jg = j_init_gate(jax.random.PRNGKey(1), jcfg.n_experts)
    js = j_init_state(jcfg)
    for ours, theirs in ((tp, jp), (tg, jg), (ts, js)):
        mine = jax.tree_util.tree_map(np.shape, params_to_jax(ours)[0])
        ref = jax.tree_util.tree_map(np.shape, _np(theirs))
        assert mine == ref
    assert float(tp["hash_table"].abs().max()) <= 1e-4


def test_render_rays_chunked_pads_and_gates_depth(models):
    _, (tcfg, tp, tg, ts) = models
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(50, 3)) * [0.3, 0.3, 0] + [0, 0, 1.0]
    dirs = torch.from_numpy(dirs.astype(np.float32))
    # camera at (0, -1.2, 0.1) looking along +y: columns right, down, fwd
    pose = torch.tensor([[1.0, 0, 0, 0], [0, 0, 1, -1.2], [0, -1, 0, 0.1]])
    out = render_rays_chunked(tp, ts, tcfg, tg, dirs, pose, RenderConfig(),
                              chunk=32)
    assert out["rgb"].shape == (50, 3) and out["depth"].shape == (50,)
    # chunk 2 holds 18 rays padded to 32 with copies of its last one
    padded = torch.cat([dirs[32:], dirs[-1:].expand(14, 3)])
    ro, rd = get_rays(padded, pose)
    ref = ml_render_test(tp, ts, tcfg, tg, ro, rd, rd, RenderConfig())
    assert torch.equal(out["rgb"][32:], ref["rgb"][:18])
    assert torch.equal(out["depth"][32:],
                       (ref["depth"] * ref["gating_code"]).sum(1)[:18])
    assert (out["opacity"] > 0.05).any()


def test_unported_paths_raise(models):
    """The dense test layout, once refused, is ported: with or without
    union sampling (which applies to the flat test layout only) it is
    each expert's dense render_test, the two renders equal (held against
    JAX in test_torch_dense)."""
    _, (tcfg, tp, tg, ts) = models
    o, d = map(torch.from_numpy, _rays(8))
    outs = [ml_render_test(tp, ts, tcfg, tg, o, d, d, RenderConfig(
        test_layout="dense", union_sampling=union)) for union in (True,
                                                                  False)]
    for k in ("rgb", "depth", "opacity", "total_samples"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert outs[0]["iterations"] == outs[1]["iterations"] > 0


def test_get_rays_writes_out_the_cpu_einsum():
    """get_rays' written-out dot products give the CPU einsum's bits (the
    card's batched matmul would round them otherwise; the card test holds
    the card to the same bits), for per-ray and shared poses."""
    gen = torch.Generator().manual_seed(0)
    d = torch.randn((5000, 3), generator=gen)
    c2w = torch.randn((5000, 3, 4), generator=gen)
    for pose in (c2w, c2w[0]):
        o, r = get_rays(d, pose)
        full = pose.expand(5000, 3, 4)
        assert torch.equal(r, torch.einsum("nc,nbc->nb", d, full[..., :3]))
        assert torch.equal(o, full[..., 3])
