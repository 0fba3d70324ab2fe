"""A run's last line: exactly the result's keys, the cell's metrics,
and no module of JAX or of the JAX package loaded in its process."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT, SPEC, run, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("name", CELLS)
def test_last_line_has_the_result_keys(name):
    out = tiny_run(name)
    assert list(out) == KEYS
    assert json.loads(json.dumps(out)) == out
    want = [m["name"] for m in run.cell_metrics(SPEC, name, False)]
    assert sorted(out["metrics"]) == sorted(want)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("radnerf_tpu_torch_probe", sys)
    names = run.forbidden_modules()
    assert "radnerf_tpu_torch" not in names
    assert "radnerf_tpu_torch_probe" not in names


@pytest.mark.parametrize("name", [CELLS[0], CELLS[-1]])
def test_a_run_loads_no_jax(name):
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests');"
        "import tiny; tiny.tiny_run(%r);"
        "from benchmark import run;"
        "print(sorted({m.split('.')[0] for m in sys.modules}))" % name)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "radnerf_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "radnerf_tpu"}


def test_main_refuses_without_a_card(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
