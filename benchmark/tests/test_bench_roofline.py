"""The yardstick's arithmetic on shapes worked by hand."""

from __future__ import annotations

import math

import pytest

from tiny import ROOT, run  # noqa: F401  (puts the repo on sys.path)

from benchmark.reference import rad_moe, roofline, switch
from benchmark.reference.nerf import Field


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e9 * 2) == pytest.approx(2e-3)


def test_kernel_costs():
    # 1000 points, 16 levels: 12 + 64 bytes and 960 operations a point
    assert roofline.encode_cost(1000, 16) == (76_000, 960_000)
    # the gradient: 12 + 128 bytes a point, a 2^19 x 16 table of f32 pairs
    assert roofline.table_grad_cost(1000, 16, 16 * 2 ** 19) == (
        140_000 + 16 * 2 ** 19 * 8, 960_000)
    assert roofline.occ_lookup_cost(1000) == (17_000, 24_000)
    assert roofline.roofline_pct((3.35e9, 0), 2e-3) == pytest.approx(50.0)
    assert roofline.roofline_pct((1, 1), 0.0) is None


def test_mfu():
    assert roofline.mlp_flops(10, True) == 60 and roofline.mlp_flops(
        10, False) == 20
    assert roofline.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    assert roofline.mfu_pct(0, 1.0) is None


def test_multiply_adds_per_sample():
    m = run.load_json(ROOT, "benchmark/configs/rad_tat_k2.json")["model"]
    geo = 32 * 64 + 64 * 17
    rgb = 32 * 64 + 64 * 64 + 64 * 3
    assert rad_moe.flops_per_sample(m) == 2 * (geo + rgb)
    assert rad_moe.flops_per_ray(m) == 6 * 64 + 3 * 64 * 64 + 64 * 2
    s = run.load_json(ROOT, "benchmark/configs/switch_tat_k2.json")["model"]
    gate = 32 * 64 + 64 * 64 + 64 * 2
    inter = 32 * 64 + 64 * 64 + 64 * 32
    assert switch.flops_per_sample(s) == 2 * gate + inter + geo + rgb


def test_field_constants():
    f = Field(run.load_json(ROOT, "benchmark/configs/rad_tat_k2.json")[
        "model"])
    assert f.cascades == 1 and f.k_candidates == 1024
    assert f.dt == pytest.approx(math.sqrt(3) / 1024)
    assert f.level_res[0] == 16 and f.level_res[-1] == 1024
