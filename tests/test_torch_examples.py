"""The port's example scripts run on the CPU at a small size and print every
report label that their JAX twins in examples/ print (smoke_e2e's
progress lines, convergence's JSON rows and SUMMARY line), so that the
two outputs read side by side. A CPU run's first line is `cpu`; a run that
asks for CUDA where there is none fails (no fallback)."""

import functools

import pytest
import torch

from radnerf_tpu_torch.examples import (
    bench_brick3, bench_brick_fetch, bench_brick_grad, bench_gather_shapes,
    bench_hashgrid, bench_render, bench_scatter, bench_vmem_gather,
    convergence, profile_ops, profile_step, proto_pallas_gather, smoke_e2e,
    trace_step,
)
from radnerf_tpu_torch.train import trainer as tt

torch.set_num_threads(2)

# script -> (a small CPU run, the labels its JAX twin prints)
SCRIPTS = {
    "bench_vmem_gather": (
        lambda: bench_vmem_gather.run(16_384, device="cpu", iters=2),
        ["# table", "xla_scalar        :", "tal_sublane       :",
         "rowgather_onehot  :"]),
    "proto_pallas_gather": (
        lambda: proto_pallas_gather.run(4096, 16_384, device="cpu"),
        ["XLA gather (", "XLA scatter-add", "pallas gather (",
         "  correct: True", "pallas scatter-add ("]),
    "profile_step": (
        lambda: profile_step.run(32, 16, "dedup", 1.0, "cpu", 10, 16),
        ["full step", "fw+bw (no adam)", "fw+bw, table sg", "fw+bw, model sg",
         "composite fw+bw", "render fw only", "union march",
         "encode fw [dedup ]", "encode fwbw [dedup ]", "encode fw [slab  ]",
         "encode fwbw [slab  ]", "geo+rgb MLPs", "step, encode stub"]),
    "trace_step": (
        lambda: trace_step.run(32, 16, "brick3", 1.0, 2, "cpu", 10, 16),
        ["# warmup", "# traced 2 steps", "== total device",
         "== by framework op path =="]),
    "bench_hashgrid": (
        lambda: bench_hashgrid.run(1024, 12, device="cpu"),
        ["# N=1024", "fw only (xla gather):", "fw+bw (xla scatter ):",
         "fw+bw (pallas      ):"]),
    "bench_scatter": (
        lambda: bench_scatter.run(1024, 12, device="cpu"),
        ["fw only (xla gather)", "fw+bw (xla scatter)", "fw+bw (pallas RMW)",
         "fw+bw (sort-based)", "fw+bw (sorted-window)",
         "lax.sort (1 key + 2 payload)", "lax.sort (key only)", "cumsum",
         "scatter-add scalar (sorted)", "scatter-add F=2 rows (sorted)",
         "window-scatter kernel alone", "gather scalar (unsorted)",
         "gather scalar (sorted hint)", "gather F=2 rows (sorted hint)",
         "fw sort->gather->unsort", "rows width   2", "rows width  16",
         "rows width  64"]),
    "bench_brick_grad": (
        lambda: bench_brick_grad.run(1024, 12, device="cpu"),
        ["table grad full", "  stream build", "  build + sort(4xf32)"]),
    "bench_brick3": (
        lambda: bench_brick3.run(1024, 12, device="cpu"),
        [f"{s:5s} {v}: fw" for s in ("ray", "rand")
         for v in ("brick  (2-row)", "brick3 (plain)", "brick3 (runs) ")]),
    "bench_gather_shapes": (
        lambda: (bench_gather_shapes.run(16_384, device="cpu"),
                 bench_gather_shapes.run_complex(16_384, device="cpu")),
        ["scalar   ", "pair-row (A,2,128)", "slab22 (A,2,2,128)",
         "cube222 (A,2,2,2,128)", "pair-row + consume", "slab22 + consume",
         "scalar sorted-hint", "complex64 scalar gather",
         "2x u32 scalar gathers"]),
    "bench_brick_fetch": (
        lambda: bench_brick_fetch.run(2048, 256, device="cpu"),
        ["scalar8 :", "brick2  :"]),
    "smoke_e2e": (
        lambda: smoke_e2e.run(8, 128, device="cpu"),
        ["step 0: loss=", "step 7: loss=", "steps in ", "PSNR "]),
    "smoke_e2e_moe": (
        lambda: smoke_e2e.run(4, 128, moe=True, device="cpu"),
        ["step 0: loss=", "step 3: loss=", "steps in ", "PSNR "]),
    "convergence_sphere": (
        lambda: convergence.main(["sphere", "--steps", "3", "--batch", "64",
                                  "--eval_every", "2", "--eval_rays", "256",
                                  "--device", "cpu"]),
        ['{"step": 0, "psnr":', '{"step": 2, "psnr":',
         'SUMMARY {"exp": "sphere"']),
    "convergence_hard": (
        lambda: convergence.main(["hard", "--render", "per_expert",
                                  "--steps", "2", "--batch", "64",
                                  "--eval_every", "1", "--eval_rays", "128",
                                  "--levels", "4", "--log2_T", "10",
                                  "--device", "cpu"]),
        ['{"step": 1, "psnr":', 'SUMMARY {"exp": "hard"',
         '"render": "per_expert"']),
    "convergence_sphere_dense": (
        lambda: convergence.main(["sphere", "--layout", "dense", "--steps",
                                  "2", "--batch", "64", "--eval_every", "1",
                                  "--eval_rays", "128", "--levels", "4",
                                  "--log2_T", "10", "--device", "cpu"]),
        ['{"step": 1, "psnr":', 'SUMMARY {"exp": "sphere"',
         '"layout": "dense"']),
    "bench_render_flat": (
        lambda: bench_render.run(32, 512, 2, 128, 8, "flat", plain=True,
                                 log2_T=12, device="cpu"),
        ["render_test (flat, plain)", "flat + host compaction",
         "[cold]", "[warm]"]),
    "bench_render_dense": (
        lambda: bench_render.run(32, 512, 2, 128, 8, "dense", plain=True,
                                 log2_T=12, device="cpu"),
        ["render_test (dense, plain)", "dense + host compaction"]),
    "profile_ops": (
        lambda: profile_ops.run(4096, 64, 32, log2_T=12, device="cpu",
                                iters=1),
        ["hashgrid fwd (4k pts, L16 T2^12)", "hashgrid fwd+bwd",
         "march (64 rays, K=1024 cand)", "composite fwd (64x32)",
         "composite fwd+bwd", "geo MLP fwd (4k x 32->64->17)",
         "geo MLP fwd+bwd"]),
    # the system's density grid (128^3, no flag) cut to 32^3 and 4 levels,
    # as tests/test_torch_system.py does
    "convergence_scene": (
        lambda: _small_system(convergence.main)(
            ["scene", "--steps", "3", "--batch", "256", "--eval_every", "2",
             "--device", "cpu"]),
        ['{"step": 0, "val_psnr":', '{"step": 2, "val_psnr":',
         'SUMMARY {"exp": "scene"']),
}


def _small_system(fn):
    def call(*a):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tt, "NGPConfig", functools.partial(
                tt.NGPConfig, grid_size=32, n_levels=4))
            return fn(*a)
    return call


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_example_prints_its_jax_twins_labels(script, capsys):
    run, labels = SCRIPTS[script]
    run()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    missing = [lab for lab in labels
               if not any(line.startswith(lab) or f" {lab}" in line
                          for line in lines)]
    assert not missing, (missing, lines)


def test_main_parses_the_jax_flags_and_device(capsys):
    bench_vmem_gather.main(["--elems", "4096", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu" and lines[1].endswith("E = 0.0M")


def test_asking_for_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        bench_vmem_gather.run(256, device="cuda")


def test_gather_kernels_results_on_cpu():
    """The wrappers' results at the script's input draws: the three
    gathers against numpy on the same words, the scatter's row sums."""
    x = bench_vmem_gather.make_inputs(4096, 64, "cpu")
    tbl = x["tbl"].numpy()
    assert (bench_vmem_gather.tal_sublane(x["tbl"], x["rows2d"]).numpy()
            == tbl[x["rows2d"].numpy(), range(128)]).all()
    assert (bench_vmem_gather.rowgather_onehot(
        x["tbl"], x["row"], x["lane"]).numpy().reshape(-1)
        == tbl.reshape(-1)[x["flat"].numpy()]).all()
    p = proto_pallas_gather.make_inputs(512, 2048, "cpu")
    got = proto_pallas_gather.pallas_scatter(p["idx"], p["vals"], 512)
    torch.testing.assert_close(got.sum(0), p["vals"].sum(0), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(proto_pallas_gather.pallas_gather(p["table"],
                                                         p["idx"]),
                       p["table"][p["idx"].long()])


def test_profile_steps_encode_stub_takes_effect():
    """With the stub, the step's table gradient reaches only the one
    entry the stub reads; without it, the encode's corners."""
    s = profile_step.build_step(32, 16, "dedup", 1.0, "cpu", 10, 16)
    table = s["bundle"]["model"]["hash_table"]

    def table_grad():
        s["optimizer"].zero_grad(set_to_none=True)
        s["loss_fn"](s["bundle"]).backward()
        return table.grad

    touched = int((table_grad() != 0).sum())
    with profile_step.encode_stubbed():
        g = table_grad()
    assert int((g != 0).sum()) <= 1 and g[1:].abs().sum() == 0
    assert touched > 2


def test_trace_step_files_backward_ops_under_the_forward_function():
    """A forward and backward through ops/compositing.py::segmented_cumsum
    (its blocked form, one bmm): the backward's ops, whose autograd nodes
    the forward created, go under that function as its backward; the
    loss's own nodes, created outside the port, stay under their node."""
    from torch.profiler import ProfilerActivity, profile

    from radnerf_tpu_torch.ops.compositing import segmented_cumsum

    gen = torch.Generator().manual_seed(0)
    v = torch.randn((1024, 2), generator=gen, requires_grad=True)
    seg = torch.zeros(1024, dtype=torch.bool)
    seg[::100] = True
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        segmented_cumsum(v, seg).square().sum().backward()
    _, ops = trace_step.attribute_ops(trace_step.load_trace(prof))
    by_src = {}
    for name, _, src in ops:
        by_src.setdefault(src, []).append(name)
    fwd = [s for s in by_src if s.endswith(": segmented_cumsum")]
    assert len(fwd) == 1 and fwd[0].startswith(
        "radnerf_tpu_torch/ops/compositing.py(")
    bwd = by_src.get(f"{fwd[0]} (backward)", [])
    assert "BmmBackward0" in bwd and "aten::bmm" in bwd
    assert not any(s.startswith("(backward) Bmm") for s in by_src)
    assert "(backward) PowBackward0" in by_src       # the test's square()
