"""The comparison that decides `correct`, at a size the CPU holds: the
program matches the reference; the reference in float8 put in the
program's place (the control) fails it; and with the timed path broken
underneath, a run comes out not correct, once for each fault a cell can
have."""

from __future__ import annotations

import pytest

from tiny import RENDER, TRAIN, tiny_cell, tiny_run

import torch

from benchmark import control

FAULTS = [(n, f) for n in TRAIN
          for f in ("unchanged", "grid_unchanged", "half_batch")] + [
    (n, f) for n in RENDER for f in ("altered", "half_batch")]


def _passes(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_the_program_matches_the_reference(name):
    assert tiny_run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_the_float8_control_fails(name):
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    if name in TRAIN:
        nums = control.train_readings(cell, 5, "fp8", cpu)
    else:
        nums = control.render_readings(cell, 5, "fp8", 0.5, cpu)
    assert not _passes(nums, cell["cell"]["limits"]), nums


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    assert not tiny_run(name, fault=fault)["correct"]
