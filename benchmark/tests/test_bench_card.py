"""On the card: a traced run of every cell at the CPU tests' size reads
every per-layer metric and the device's busy time (skips without a
CUDA device)."""

from __future__ import annotations

import pytest

from tiny import CELLS, SPEC, run, tiny_cell

import torch


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_per_layer_metrics(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(name, 12345, 1.0, True, device="cuda", spec=SPEC,
                       cell=tiny_cell(name), log=lambda *a: None)
    want = {m["name"] for m in run.cell_metrics(SPEC, name, True)}
    assert set(out["metrics"]) == want
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
