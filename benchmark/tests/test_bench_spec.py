"""BENCHMARK.json and the files it names: every one parses, every name
keeps its format, and the harness finds each cell's parts by
name alone."""

from __future__ import annotations

import importlib.util
import os
import re

import pytest

from tiny import CELLS, ROOT, SPEC, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_spec_has_its_keys_and_names():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_are_found_by_name(name):
    cell = run.find_cell(SPEC, name)
    assert cell["traffic"]["driver"] in ("train", "render")
    conf = cell["config"]
    for mod in ("systems", "reference"):
        key = "system" if mod == "systems" else "reference"
        assert os.path.exists(os.path.join(ROOT, "benchmark", mod,
                                           f"{conf[key]}.py"))
    e2e = run.cell_metrics(SPEC, name, False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    per_layer = run.cell_metrics(SPEC, name, True)
    assert per_layer
    for m in per_layer:
        path = os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py")
        s = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert callable(mod.read)
        assert m["moves"] in [e["name"] for e in e2e]
    limits = set(cell["cell"]["limits"])
    assert limits >= {"loss_gap"} or limits >= {"rgb_gap"}


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_hold_what_is_run(conf):
    c = run.load_json(ROOT, conf["file"])
    assert c["source"] == conf["source"]
    assert c["reduced"] == conf["reduced"]
    for k in ("flags", "model", "train", "scene", "assumed"):
        assert k in c
