"""The program's spans and counters (radnerf_tpu_torch/utils/trace.py):
the span tree of a training step and of a chunked test render under a
CPU torch.profiler, the same names as `user_annotation` events of the
exported trace, nothing recorded without a profiler, the ring's bound,
bit-equal training with and without a profiler, the launch counters,
and the sync counter's warning handling.

The tests marked `cuda` run the MoE and Switch training steps and the
MoE test render on the card under a CUDA profiler: each `sync` the
program counts is one synchronizing runtime call of the trace, inside a
`sync.*` span, and every span starts where its annotation does. On the
card (the machine has no JAX, so without the JAX conftest):

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

from __future__ import annotations

import contextlib
import json
import math
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mngp import (
    MNGPConfig, init_mngp, init_mngp_state,
)
from radnerf_tpu_torch.parallel.mesh import single_rank_mesh
from radnerf_tpu_torch.parallel.step import tree_leaves
from radnerf_tpu_torch.render.ml_render import render_rays_chunked
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.utils import trace

CFG = MNGPConfig(n_experts=2, log2_T=12, grid_size=16, n_levels=4,
                 compute_dtype="bfloat16", hash_impl="brick3")
N_IMG, SIDE = 3, 12


def _store(device, n_img=N_IMG, side=SIDE) -> dict:
    """Cameras on a ring around the scene, looking at its centre, and
    random pixels."""
    gen = torch.Generator().manual_seed(3)
    u = (torch.arange(side) + 0.5) / side - 0.5
    yy, xx = torch.meshgrid(u, u, indexing="ij")
    dirs = torch.stack([xx, -yy, -torch.ones_like(xx)], -1).reshape(-1, 3)
    poses = []
    for i in range(n_img):
        a = 2 * math.pi * i / n_img
        z = torch.tensor([math.sin(a), 0.0, math.cos(a)])
        x = torch.tensor([math.cos(a), 0.0, -math.sin(a)])
        y = torch.cross(z, x, dim=0)
        poses.append(torch.stack([x, y, z, 1.2 * z], 1))
    rays = torch.rand((n_img, side * side, 3), generator=gen)
    return {k: v.to(device) for k, v in (
        ("rays", rays), ("poses", torch.stack(poses)), ("directions", dirs))}


def _trainer(device="cpu", cfg=CFG, seed=1, batch=128, microbatch=2,
             **train) -> tt.Trainer:
    gen = torch.Generator().manual_seed(seed)
    params = init_mngp(gen, cfg, device=device)
    gate = init_ray_gate(gen, cfg.n_experts, device=device)
    tcfg = tt.TrainConfig(batch_size=batch, microbatch=microbatch,
                          warmup_steps=16, budget_per_ray=16,
                          adaptive_budget=False, layout="flat", **train)
    return tt.Trainer(cfg, tcfg, params, gate,
                      init_mngp_state(cfg, device=device),
                      _store(device), torch.Generator(
                          device=device).manual_seed(seed),
                      mesh=single_rank_mesh(torch.device(device)))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def tracing_ends():
    """A span entered with no profiler running ends the tracing a test
    started (the sync mode and warning filters go back)."""
    yield
    with trace.span("end"):
        pass


def _tree(recs) -> dict:
    """{id: record} and {parent id: [child names]}."""
    by_id = {r.id: r for r in recs}
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r.name)
    return by_id, kids


def _events(prof, tmp_path) -> list:
    """The profiler's exported Chrome trace events (a trace exports
    once)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _annotations(events, cat="user_annotation", names=None) -> list:
    """The complete events of `cat` (of `names` only, if given: PyTorch
    annotates some calls itself, e.g. the optimizer's step)."""
    return [e for e in events if e.get("cat") == cat and e.get("ph") == "X"
            and (names is None or e["name"] in names)]


def test_a_training_step_records_its_span_tree(tmp_path):
    trainer = _trainer()
    trace.reset()
    with _cpu_profile() as prof:
        trainer.fit_steps(1)
    recs = trace.records()
    by_id, kids = _tree(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["train.step"]
    root = roots[0]
    assert sorted(kids[root.id]) == sorted(
        ["train.grid_update", "train.batch", "step.slice", "step.backward",
         "step.slice", "step.backward", "step.adam"])
    for s in (r for r in recs if r.name == "step.slice"):
        assert {"render.gate", "render.march", "render.encode",
                "render.mlp", "render.composite", "loss"} <= set(kids[s.id])
    grid = next(r for r in recs if r.name == "train.grid_update")
    assert sorted(kids[grid.id]) == ["render.encode", "render.encode",
                                     "render.mlp", "render.mlp"]
    march = [r for r in recs if r.name == "render.march"]
    assert all(by_id[r.parent].name == "step.slice" for r in march)
    assert {"sync.march_ratio", "sync.march_dt", "sync.occ_bounds"} <= {
        n for r in march for n in kids.get(r.id, [])}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert all(r.syncs == 0 for r in recs)          # no CUDA here
    ann = _annotations(_events(prof, tmp_path),
                       names={r.name for r in recs})
    assert sorted(e["name"] for e in ann) == sorted(r.name for r in recs)
    # the records convert onto the trace's clock
    first = min(ann, key=lambda e: e["ts"])
    assert first["name"] == "train.step"
    assert abs((root.start_ns - root.base_ns) / 1e3 - first["ts"]) < 5e3


def test_a_chunked_test_render_has_a_root_a_chunk(tmp_path):
    trainer = _trainer()
    trainer.fit_steps(1)            # a warm-up grid update: occupancy
    b, st = trainer.bundle, trainer.model_state
    store = trainer.data
    n_pix, chunk = store["directions"].shape[0], 64
    trace.reset()
    with _cpu_profile():
        out = render_rays_chunked(
            b["model"], st, CFG, b["gate"], store["directions"],
            store["poses"][0], trainer.rcfg, chunk=chunk,
            mean_dir=store["mean_dir"])
    recs = trace.records()
    by_id, kids = _tree(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["test.chunk"] * -(-n_pix // chunk)
    iters = [r for r in recs if r.name == "test.iteration"]
    assert out["iterations"] > 0 and len(iters) == out["iterations"]
    assert all(by_id[r.parent].name == "test.chunk" for r in iters)
    for r in roots:
        # each loop's condition, one read more than its iterations, and
        # the chunk's sample count
        n_it = kids[r.id].count("test.iteration")
        assert kids[r.id].count("sync.test_alive") == n_it + 1
        assert kids[r.id].count("sync.total_samples") == 1
    for r in iters:
        assert {"render.march", "render.encode", "render.mlp",
                "render.composite"} <= set(kids[r.id])


def test_no_profiler_records_nothing():
    trace.reset()
    trainer = _trainer()
    trainer.fit_steps(2)
    assert trace.records() == []
    assert "sync" not in trace.counters()
    assert trace.span("a") is trace.span("b")
    with _cpu_profile():
        on = trace.span("a")
        assert on is not trace.span("a")
    assert trace.span("a") is trace.span("b")


def test_the_ring_keeps_its_bound():
    trace.reset()
    with _cpu_profile():
        for _ in range(trace.RING + 10):
            with trace.span("x"):
                pass
    recs = trace.records()
    assert len(recs) == trace.RING
    assert recs[-1].id - recs[0].id == trace.RING - 1
    trace.reset()
    assert trace.records() == []


def test_training_is_bit_equal_with_and_without_a_profiler():
    runs = []
    for traced in (False, True):
        trainer = _trainer(seed=7)
        losses = []
        with _cpu_profile() if traced else contextlib.nullcontext():
            trainer.fit_steps(2, lambda s, loss, aux: losses.append(loss))
        runs.append((losses, [p.detach() for p in
                              tree_leaves(trainer.bundle)]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert len(p0) == len(p1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_launches_are_counted_and_reset(monkeypatch):
    monkeypatch.setattr(kernels, "_entry_point",
                        lambda name: (lambda *a: 0 if a[0] else 7))
    trace.reset()
    kernels.launch("occ_lookup", 1)
    kernels.launch("occ_lookup", 1)
    kernels.launch("brick3_table_grad", 1)
    with pytest.raises(RuntimeError, match="cudaError 7"):
        kernels.launch("brick3_table_grad", 0)
    assert trace.counters() == {"launch.occ_lookup": 2,
                                "launch.brick3_table_grad": 1}
    trace.count("launch.occ_lookup", 3)
    assert trace.counters()["launch.occ_lookup"] == 5
    assert not hasattr(kernels, "launch_counts")
    trace.reset()
    assert trace.counters() == {}


def test_sync_warnings_are_counted_under_the_open_span_and_not_shown():
    trace.reset()
    before_show = warnings.showwarning
    before_filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        inner_show = warnings.showwarning
        with _cpu_profile():
            with trace.span("sync.site"):
                for _ in range(3):
                    warnings.warn(trace.SYNC_WARNING + " (from a test)")
            with trace.span("other"):
                warnings.warn("another warning")
        assert trace.counters()["sync"] == 3
        assert [r.syncs for r in trace.records()] == [3, 0]
        assert [str(w.message) for w in shown] == ["another warning"]
        # the first sync warning after the profiler stops puts the
        # warning printer and filters back, and is not counted
        warnings.warn(trace.SYNC_WARNING)
        assert warnings.showwarning is inner_show
        assert trace.counters()["sync"] == 3
        warnings.warn(trace.SYNC_WARNING)
        assert len(shown) == 2
    assert warnings.showwarning is before_show
    assert warnings.filters == before_filters
    # a span entered after the profiler stopped also puts them back
    with _cpu_profile():
        with trace.span("x"):
            assert warnings.showwarning is not before_show
    with trace.span("y"):
        pass
    assert warnings.showwarning is before_show
    assert warnings.filters == before_filters
    # a printer set while tracing was on is left in place when it ends
    try:
        with _cpu_profile():
            with trace.span("x"):
                warnings.showwarning = mine = lambda *a, **k: None
        with trace.span("y"):
            pass
        assert warnings.showwarning is mine
        assert warnings.filters == before_filters
    finally:
        warnings.showwarning = before_show


def test_kineto_base_floors_to_trimonths():
    s = trace.TRIMONTH_S
    assert trace.kineto_base_ns(5 * s * 10**9 + 123) == 5 * s * 10**9
    assert trace.kineto_base_ns(6 * s * 10**9 - 1) == 5 * s * 10**9


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync counter reads CUDA's "
                    "sync debug mode)")
    return torch.device("cuda")


def _switch_trainer(dev):
    from radnerf_tpu_torch.models.switch import (
        SwitchNGPConfig, init_switch_ngp, init_switch_ngp_state,
    )
    from radnerf_tpu_torch.train.other_trainer import (
        other_density_fn, other_loss_fn,
    )

    cfg = SwitchNGPConfig(log2_T=14, grid_size=32,
                          compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(2)
    tcfg = tt.TrainConfig(batch_size=4096, microbatch=1, warmup_steps=16,
                          budget_per_ray=64, adaptive_budget=False,
                          layout="flat", gate_type="ray", cv_loss_w=1e-2)
    return tt.Trainer(cfg, tcfg, init_switch_ngp(gen, cfg, device=dev),
                      None, init_switch_ngp_state(cfg, device=dev),
                      _store(dev, 8, 64), torch.Generator(
                          device=dev).manual_seed(2),
                      loss=other_loss_fn("switch", None, 0.0),
                      density_fn=other_density_fn("switch"),
                      mesh=single_rank_mesh(dev))


def _card_paths(dev):
    """The cells' three paths at a small size: (name, run) pairs, each
    run made once before (kernels built, allocator warm)."""
    cfg = MNGPConfig(n_experts=2, log2_T=14, grid_size=32,
                     compute_dtype="bfloat16", hash_impl="brick3")
    moe = _trainer(dev, cfg, batch=4096, microbatch=1)
    switch = _switch_trainer(dev)
    moe.fit_steps(17)
    switch.fit_steps(17)
    b, store = moe.bundle, moe.data

    def render():
        render_rays_chunked(b["model"], moe.model_state, cfg, b["gate"],
                            store["directions"], store["poses"][0],
                            moe.rcfg, chunk=1024,
                            mean_dir=store["mean_dir"])

    paths = [("train.step", lambda: moe.fit_steps(16)),
             ("train.step", lambda: switch.fit_steps(16)),
             ("test.chunk", render)]
    for _, run in paths:
        run()
    torch.cuda.synchronize(dev)
    return paths


@pytest.mark.cuda
def test_each_sync_is_a_runtime_sync_inside_a_sync_span(dev, tmp_path):
    for root, run in _card_paths(dev):
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(dev)
        recs = trace.records()
        roots = [r for r in recs if r.parent is None]
        assert roots and all(r.name == root for r in roots)
        n_sync = trace.counters().get("sync", 0)
        assert n_sync == sum(r.syncs for r in recs) > 0
        assert sum(r.syncs for r in recs if r.name.startswith("sync.")) \
            == n_sync
        base = roots[0].base_ns
        spans = [((r.start_ns - base) / 1e3, (r.end_ns - base) / 1e3)
                 for r in roots]
        calls = [e for e in _annotations(_events(prof, tmp_path),
                                         "cuda_runtime")
                 if e["name"] in SYNC_CALLS
                 and any(a <= e["ts"] <= b for a, b in spans)]
        assert len(calls) == n_sync, (root, len(calls), n_sync)


@pytest.mark.cuda
def test_spans_start_where_their_annotations_do(dev, tmp_path):
    root, run = _card_paths(dev)[0]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    recs = trace.records()
    events = _events(prof, tmp_path)
    ann = sorted(_annotations(events, names={r.name for r in recs}),
                 key=lambda e: e["ts"])
    assert sorted(e["name"] for e in ann) == sorted(r.name for r in recs)
    gaps = []
    for name in {r.name for r in recs}:
        starts = [(r.start_ns - r.base_ns) / 1e3 for r in recs
                  if r.name == name]
        gaps += [abs(a - e["ts"]) for a, e in zip(
            starts, (e for e in ann if e["name"] == name))]
    assert max(gaps) < 100.0, max(gaps)
    dev_ann = _annotations(events, "gpu_user_annotation")
    assert {e["name"] for e in dev_ann} >= {root, "render.march"}
