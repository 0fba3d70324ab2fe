"""PyTorch port vs the JAX package, the training ops: the trunc_exp
backward, the training compositor (forward and VJP, and against finite
differences in float64), the union march, the losses, the adaptive
budget ladder, the learning-rate schedule and the Adam update."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu import losses as jl
from radnerf_tpu.ops import compositing as jc
from radnerf_tpu.ops import distortion as jd
from radnerf_tpu.ops import marching as jm
from radnerf_tpu.ops.intersection import scene_near_far
from radnerf_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from radnerf_tpu.train import trainer as jt
from radnerf_tpu_torch import losses as tl
from radnerf_tpu_torch.ops import compositing as tc
from radnerf_tpu_torch.ops import distortion as td
from radnerf_tpu_torch.ops import marching as tm
from radnerf_tpu_torch.ops.trunc_exp import trunc_exp as t_trunc_exp
from radnerf_tpu_torch.train import trainer as tt

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- trunc_exp

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunc_exp_backward_matches_jax_at_clamp_edges(dtype):
    x = np.concatenate([
        np.linspace(-20, 20, 401), [-15.0, 15.0, -15.01, 15.01, 88.0, -90.0]
    ]).astype(np.float32)
    g = np.random.default_rng(0).uniform(0.5, 2.0, x.shape).astype(
        np.float32)
    xj = jnp.asarray(x, dtype)
    _, vjp = jax.vjp(j_trunc_exp, xj)
    ref = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    t_trunc_exp(xt).backward(torch.from_numpy(g))
    assert xt.grad.dtype == getattr(torch, dtype)
    got = xt.grad.float().numpy()
    # g * exp(clamp(x)) in f32, then rounded to the input dtype; the two
    # exps differ by a few f32 ulps, which a bf16 rounding may carry to
    # one bf16 ulp (2^-8 relative)
    rtol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got, ref, rtol=rtol)
    clamp = np.abs(x.astype(np.float64)) >= 15
    assert np.isfinite(got).all() and clamp.sum() > 20
    # beyond the clamp the gradient is flat: g * exp(+-15)
    hi = x >= 15
    np.testing.assert_allclose(got[hi] / g[hi], np.exp(15.0), rtol=2e-2)


# ----------------------------------------------------- training compositor

def _flat_layout(N=24, B=700, seed=0, dtype=np.float32):
    """A flat layout with empty, truncated and spilled rays; sigmas large
    enough that most rays cross the T <= 1e-4 cutoff."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(0, 60, N).astype(np.int32)
    cap[2] = 0
    bounds = np.cumsum(cap)
    assert bounds[-1] > B
    offsets = (bounds - cap).astype(np.int32)
    starts = np.zeros(B + 1, np.int32)
    np.add.at(starts, np.minimum(offsets, B), 1)
    ray_id = np.clip(np.cumsum(starts[:B]) - 1, 0, N - 1).astype(np.int32)
    valid = np.arange(B) < min(bounds[-1], B)
    deltas = np.where(valid, np.float32(np.sqrt(3) / 1024), 0).astype(dtype)
    ts = np.where(valid, np.sort(rng.uniform(0.2, 1.5, B)), 0).astype(dtype)
    sig = np.exp(rng.normal(5.0, 1.5, (2, B))).astype(dtype)
    rgb = rng.uniform(0, 1, (2, B, 3)).astype(dtype)
    member = (rng.random((2, B)) < 0.8) & valid
    return sig, rgb, member, (deltas, ts, ray_id, offsets, cap)


OUT_KEYS = ("opacity", "depth", "rgb", "ws")


def test_composite_train_flat_forward_and_vjp_match_jax():
    sig, rgb, member, shared = _flat_layout()
    cot = np.random.default_rng(1)

    def jfun(s, r):
        out = jax.vmap(lambda s_k, r_k, m_k: jc.composite_train_flat(
            s_k, r_k, *shared, m_k))(s, r, member)
        return tuple(out[k] for k in OUT_KEYS), out["vr_samples"]

    ref_out, vjp_fn = jax.vjp(lambda s, r: jfun(s, r)[0], sig, rgb)
    ref_vr = jfun(sig, rgb)[1]
    cts = tuple(cot.normal(size=np.shape(o)).astype(np.float32)
                for o in ref_out)
    ref_gs, ref_gr = vjp_fn(cts)

    s = _t(sig).requires_grad_(True)
    r = _t(rgb).requires_grad_(True)
    got = tc.composite_train_flat(s, r, *map(_t, shared), _t(member))
    for k, o in zip(OUT_KEYS, ref_out):
        # f32 segmented sums and exps in another order
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(o),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["vr_samples"].numpy(),
                                  np.asarray(ref_vr))
    torch.autograd.backward([got[k] for k in OUT_KEYS],
                            [torch.from_numpy(c) for c in cts])
    # gradients of the same sums: a few f32 ulps of the largest term
    for g, rg in ((s.grad, ref_gs), (r.grad, ref_gr)):
        rg = np.asarray(rg)
        np.testing.assert_allclose(g.numpy(), rg, rtol=1e-4,
                                   atol=1e-5 * np.abs(rg).max())
    # the cutoff stopped rays, and a dead sample passes no gradient
    w = got["ws"].detach().numpy()
    dead = member & (w == 0)
    assert dead.sum() > 50
    assert (s.grad.numpy()[dead] == 0).all()


def test_composite_train_flat_vjp_matches_finite_differences_float64():
    sig, rgb, member, shared = _flat_layout(N=10, B=200, seed=2,
                                            dtype=np.float64)
    shared = tuple(_t(a) for a in shared)
    sig, rgb, member = _t(sig), _t(rgb), _t(member)

    def f(s, r):
        out = tc.composite_train_flat(s, r, *shared, member)
        return torch.cat([out["opacity"].reshape(-1), out["depth"].reshape(-1),
                          out["rgb"].reshape(-1)])

    # the cutoff is a step in the samples' weights: keep every sample's
    # exclusive transmittance well away from it, so a small step does not
    # cross it
    with torch.no_grad():
        B = sig.shape[1]
        seg = torch.arange(B) == shared[3][shared[2].long()]
        sd = torch.where(member, sig * shared[0], 0.0)
        t_ex = torch.exp(-(tc.segmented_cumsum(sd.T, seg).T - sd))
        assert (t_ex <= 1e-4).any() and (t_ex > 1e-4).any()
        assert ((t_ex / 1e-4).log().abs() > 1e-6).all()
    s = sig.clone().requires_grad_(True)
    r = rgb.clone().requires_grad_(True)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=f(sig, rgb).shape))
    (f(s, r) * v).sum().backward()
    gen = np.random.default_rng(4)
    eps = 1e-7
    for _ in range(6):
        ds = torch.from_numpy(gen.normal(size=sig.shape)) * sig
        dr = torch.from_numpy(gen.normal(size=rgb.shape))
        fd = ((f(sig + eps * ds, rgb + eps * dr)
               - f(sig - eps * ds, rgb - eps * dr)) * v).sum() / (2 * eps)
        an = (s.grad * ds).sum() + (r.grad * dr).sum()
        # central differences in float64: O(eps^2) truncation, O(1e-16 /
        # eps) rounding
        assert abs(float(fd - an)) <= 1e-6 * max(1.0, abs(float(an)))


# ------------------------------------------------------------ union march

def _union_setup(n=64, g=32, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = -o + rng.normal(size=(n, 3)) * 0.2
    d[:5] = -d[:5]                       # pointing away: miss the box
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = (np.sqrt(xx**2 + yy**2 + zz**2) * 0.5 < 0.3)
    occ = np.stack([sphere & (rng.random(sphere.shape) < 0.8),
                    sphere & (xx > 0)])[:, None]
    noise = rng.random(n).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), occ, noise


UNION_KEYS = ("ts", "deltas", "ray_id", "valid", "offsets", "cap",
              "n_samples", "total")


@pytest.mark.parametrize("budget,cap", [(64, 192), (8, 32)])
def test_march_rays_union_flat_equals_jax(budget, cap):
    """N=64, K=1024 candidates: 256 brick blocks, so the reference takes
    its Pallas occupancy kernel. cap_scale 2; budget 8 saturates the
    buffer (the union budget truncates rays)."""
    jc_, tc_ = (jm.MarchConfig(scale=0.5, grid_size=32, samples_per_ray=cap),
                tm.MarchConfig(scale=0.5, grid_size=32, samples_per_ray=cap))
    o, d, occ, noise = _union_setup()
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    t1, t2 = (np.asarray(a) for a in jax.jit(scene_near_far)(o, d, c, h))
    assert (64 * jc_.k_candidates // jm.OCC_BLOCK) % jm.OCC_GBLK == 0
    ref, ref_mem = jax.jit(lambda o, d, t1, t2, occ, nz: jm.march_rays_union_flat(
        o, d, t1, t2, occ, jc_, nz, budget_per_ray=budget, cap_scale=2))(
        o, d, t1, t2, occ, noise)
    got, mem = tm.march_rays_union_flat(
        *map(_t, (o, d, t1, t2, occ)), tc_, _t(noise), budget_per_ray=budget,
        cap_scale=2)
    for key in UNION_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(mem.numpy(), np.asarray(ref_mem))
    assert int(got["total"]) > 0
    assert mem[0].sum() > mem[1].sum() > 0          # two different experts
    if budget == 8:      # the global budget truncated rays at the front
        big, _ = tm.march_rays_union_flat(
            *map(_t, (o, d, t1, t2, occ)), tc_, _t(noise), budget_per_ray=64,
            cap_scale=2)
        assert (got["cap"] <= big["cap"]).all()
        assert (got["cap"] < big["cap"]).sum() > 10


def test_lattice_candidates_jitter_equals_jax():
    cfg_j, cfg_t = jm.MarchConfig(), tm.MarchConfig()
    o, d, _, noise = _union_setup(seed=5)
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    t1, t2 = (np.asarray(a) for a in jax.jit(scene_near_far)(o, d, c, h))
    ref = jax.jit(lambda o, d, t1, t2, nz: jm._lattice_candidates(
        o, d, t1, t2, cfg_j, nz))(o, d, t1, t2, noise)
    got = tm._lattice_candidates(*map(_t, (o, d, t1, t2)), cfg_t, _t(noise))
    # the jittered start, the lattice, dt and the range mask: exact
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    # xyz: XLA fuses o + t d into an fma only in its vectorized loops, and
    # a (N, K, 3) array's rows of 3 leave a scalar remainder (ROADMAP
    # caveat); the port fuses everywhere. Each reference element is the
    # fused or the unfused value, bit for bit
    xyz, rxyz = got[2].numpy(), np.asarray(ref[2])
    td = (got[0].numpy()[..., None] * d[:, None, :]).astype(np.float32)
    unfused = (o[:, None, :] + td).astype(np.float32)
    assert ((rxyz == xyz) | (rxyz == unfused)).all()
    assert (xyz == rxyz).mean() > 0.5


# ------------------------------------------------------------------ losses

def _loss_results(N=96, K=2, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, K)).astype(np.float32)
    gate = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    sig, rgb, member, (deltas, ts, ray_id, offsets, cap) = _flat_layout(
        N=N, B=2000, seed=seed)
    w = (rng.random((K, 2000)) * member).astype(np.float32)

    def rep(a):
        return np.broadcast_to(a[None], (K,) + a.shape).copy()

    res = {
        "rgb": rng.uniform(0, 1, (N, 3)).astype(np.float32),
        "opacity": rng.uniform(0, 1, N).astype(np.float32),
        "depth": rng.uniform(0.2, 2, (N, K)).astype(np.float32),
        "gating_code": gate.astype(np.float32),
        "gating_importance": gate.sum(0).astype(np.float32),
        "ws": w, "deltas": rep(deltas), "ts": rep(ts), "valid": member,
        "ray_id": rep(ray_id), "offsets": rep(offsets), "cap": rep(cap),
    }
    res["opacity"][:3] = [0.0, 1.0, 1e-12]
    target = {"rgb": rng.uniform(0, 1, (N, 3)).astype(np.float32)}
    return res, target


def _distortion_scale(ws, deltas, ts, valid, ray_id, offsets, cap):
    """Per ray, sum over samples of |wts_incl * ws_excl| + |ws_incl *
    wts_excl| + w^2 delta / 3 (float64): the magnitude of the terms, two
    of which cancel in the DVGO form. f32 prefix sums in another order move
    each product by ~n u of itself (n <= 60 samples per ray), and the
    difference keeps that absolute error: tolerance 1e-5 x this."""
    B = ws.shape[0]
    seg = np.arange(B) == offsets[ray_id]
    w = np.where(valid, ws, 0.0).astype(np.float64)
    wt = w * ts
    out = np.zeros(len(cap))
    a = b = 0.0
    for i in range(B):
        if seg[i]:
            a = b = 0.0
        a, b = a + w[i], b + wt[i]
        if valid[i]:
            out[ray_id[i]] += (abs(b * (a - w[i])) + abs(a * (b - wt[i]))
                               + w[i] * w[i] * deltas[i] / 3)
    return out


LOSS_W = dict(lambda_opacity=1e-3, lambda_distortion=1e-3,
              lambda_cv_importance=1e-2, lambda_depth_mutual=5e-3)


def test_nerf_loss_and_total_loss_match_jax():
    res, target = _loss_results()
    diff = ("rgb", "opacity", "depth", "gating_code", "gating_importance",
            "ws")
    ref = jl.nerf_loss(res, target, **LOSS_W)
    ref_g = jax.grad(lambda p: jl.total_loss(jl.nerf_loss(
        {**res, **p}, target, **LOSS_W)))({k: res[k] for k in diff})
    tres = {k: _t(v) for k, v in res.items()}
    for k in diff:
        tres[k].requires_grad_(True)
    got = tl.nerf_loss(tres, {"rgb": _t(target["rgb"])}, **LOSS_W)
    assert sorted(got) == sorted(ref) == sorted(
        ["rgb", "opacity", "distortion", "cv_importance", "depth_mutual"])
    for k in ref:
        if k == "distortion":
            continue
        # f32 logs, variances and sums in another order
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    scale = np.mean([_distortion_scale(*(res[k][e] for k in (
        "ws", "deltas", "ts", "valid", "ray_id", "offsets", "cap")))
        for e in (0, 1)], axis=0)
    dist = got["distortion"].detach().numpy()
    assert (np.abs(dist - np.asarray(ref["distortion"]))
            <= 1e-5 * LOSS_W["lambda_distortion"] * scale + 1e-12).all()
    tot = tl.total_loss(got)
    np.testing.assert_allclose(float(tot), float(jl.total_loss(ref)),
                               rtol=1e-6)
    tot.backward()
    for k in diff:
        # the ws gradient runs through the distortion's prefix sums: the
        # same cancellation, so an error bound relative to its largest
        # entry; the others are f32 elementwise
        rg = np.asarray(ref_g[k])
        atol = 1e-5 * np.abs(rg).max() if k == "ws" else 1e-9
        g = tres[k].grad
        if k == "gating_code":      # used only under a stop-gradient
            assert g is None and not rg.any()
            continue
        np.testing.assert_allclose(g.numpy(), rg, rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_distortion_loss_flat_matches_jax():
    res, _ = _loss_results(seed=3)
    args = [res[k][0] for k in ("ws", "deltas", "ts", "ray_id", "offsets",
                                "cap", "valid")]
    ref = jax.jit(jd.distortion_loss_flat)(*args)
    got = td.distortion_loss_flat(*map(_t, args))
    assert got.shape == (96,)
    scale = _distortion_scale(*args[:3], args[6], *args[3:6])
    assert (np.abs(got.numpy() - np.asarray(ref)) <= 1e-5 * scale
            + 1e-12).all()
    assert (got.numpy() > 0).sum() > 50


# --------------------------------------------------- budget, lr and Adam

@pytest.mark.parametrize("cur", [16, 24, 64, 112, 192, 288])
@pytest.mark.parametrize("util", [0.0, 0.1, 0.3, 0.44, 0.45, 0.7, 0.95,
                                  0.951, 1.0])
def test_next_budget_bucket_matches_jax(cur, util):
    ladder = tt.budget_buckets(3)
    assert ladder == tuple(sorted(set(jt.BUDGET_BUCKETS) | {
        b * k for b in (64, 80, 96) for k in (2, 3)}))
    for buckets in (tt.BUDGET_BUCKETS, ladder):
        assert tt.next_budget_bucket(cur, util, buckets) == \
            jt.next_budget_bucket(cur, util, buckets)
    assert tt.BUDGET_BUCKETS == jt.BUDGET_BUCKETS
    assert (tt.UPDATE_INTERVAL, tt.MAX_SAMPLES, tt.DENSITY_THRESHOLD) == (
        jt.UPDATE_INTERVAL, jt.MAX_SAMPLES, jt.DENSITY_THRESHOLD)


def j_optimizer(tcfg):
    """The reference's own schedule and Adam: NeRFSystem.configure_optimizers
    run on a stand-in holding only what it reads."""
    system = SimpleNamespace(
        h=SimpleNamespace(lr=tcfg.lr, num_epochs=tcfg.num_epochs),
        train_dataset=SimpleNamespace(STEPS_PER_EPOCH=tcfg.steps_per_epoch),
        ext_params=None, _bundle_params=dict)
    jt.NeRFSystem.configure_optimizers(system)
    return system.lr_schedule, system.optimizer


def test_lr_schedule_and_adam_match_optax():
    tcfg = tt.TrainConfig(steps_per_epoch=10, num_epochs=4)
    js, opt = j_optimizer(tcfg)
    for step in (0, 9, 10, 25, 39, 40, 1000):
        np.testing.assert_allclose(tt.lr_schedule(tcfg, step),
                                   float(js(step)), rtol=1e-6)
    assert tt.lr_schedule(tcfg, 0) == tcfg.lr

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(40, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** i
              for k, v in p0.items()} for i in (-3, 0, 2)]
    grads[1]["b"][:3] = 0.0                       # untouched entries
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = opt.init(jp)
    tp = {k: _t(v.copy()).requires_grad_(True) for k, v in p0.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=tcfg.lr, eps=1e-15)
    for i in range(12):
        g = grads[i % 3]
        up, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, up)
        for group in topt.param_groups:
            group["lr"] = tt.lr_schedule(tcfg, i)
        for k, v in tp.items():
            v.grad = _t(g[k])
        topt.step()
    for k in p0:
        # the same Adam in another f32 evaluation order: each of the 12
        # steps rounds the parameter (half an ulp) and its update (a few
        # ulps of ~lr)
        moved = np.abs(np.asarray(jp[k]) - p0[k]).max()
        ulp = np.spacing(np.abs(p0[k]).max() + moved)
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=12 * ulp + 1e-5 * moved)
