"""Run one cell of the benchmark of the PyTorch + CUDA port once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name from BENCHMARK.json at the
root of the checkout: the cell's configuration (benchmark/configs/
<config>.json: the launch script's flags, the sizes, the system and
reference modules), its traffic (benchmark/traffic/<traffic>.json: the
driver, its flags and parameters), the cell's own flags and the limits
of its comparison (benchmark/cells/<cell>.json), and each per-layer
metric's reader (benchmark/metrics/<metric>.py, `read(ctx) -> number or
None`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown, and last the
numbers compared, each beside its limit; the same numbers close standard
error. Without a CUDA device, or with JAX loaded, it prints no result
and exits with 1.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "radnerf_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    """The workload entry of BENCHMARK.json and its configuration,
    traffic and cell file, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    return {"workload": w,
            "config": load_json(BENCH, "configs", f"{w['config']}.json"),
            "traffic": load_json(BENCH, "traffic", f"{w['traffic']}.json"),
            "cell": load_json(BENCH, "cells", f"{name}.json")}


def cell_metrics(spec: dict, name: str, trace: bool) -> list:
    """The metrics this cell reports: end-to-end, or per-layer with
    --trace 1 (a metric with `workloads` only in those cells)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def read_metric(metric: dict, ctx: dict):
    path = os.path.join(BENCH, "metrics", f"{metric['name']}.py")
    s = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric['name'].replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name, clocks and power limit (read-only nvidia-smi)."""
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return q.stdout.strip() or q.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def checks(numbers: dict, limits: dict) -> dict:
    """Each number that has a limit, beside it (a number with none is
    only logged)."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str | None = None,
             spec: dict | None = None, cell: dict | None = None,
             log=None) -> dict:
    """One run of a cell: the result object (without the device check,
    which main makes)."""
    import torch

    log = log or (lambda *a: print(*a, flush=True))
    spec = spec or load_json(ROOT, "BENCHMARK.json")
    cell = cell or find_cell(spec, name)
    sys.path.insert(0, ROOT)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    torch.set_num_threads(2)
    res = driver.run(cell, seed, seconds, trace, torch.device(device),
                     T_START, fault=fault, log=log)
    if trace:
        metrics = {}
        for m in cell_metrics(spec, name, True):
            v = read_metric(m, res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell_metrics(spec, name, False)}
    cmp = checks(res["numbers"], cell["cell"]["limits"])
    log(f"numbers: {res['numbers']}")
    correct = all(c["value"] <= c["limit"] for c in cmp.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": res["ctx"]["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        from benchmark.reference import trace as tr

        span = res["ctx"]["span"]
        dev["busy_s"] = span["busy_s"]
        dev["window_s"] = span["window_s"]
        out["breakdown"] = {
            "device_ops": tr.top_ops(span["items"]),
            "idle_gaps": tr.idle_gaps(res["ctx"]["span_stack"]["items"],
                                      res["ctx"]["span_stack"]["frames"])}
    out["compared"] = cmp
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # kernel caches at fixed paths inside the checkout (the program builds
    # its own CUDA sources into radnerf_tpu_torch/_build)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

    spec = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(spec, args.workload)
    need = cell["workload"]["chips"]
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"no result: the cell needs {need} CUDA device(s), {have} "
              f"found", file=sys.stderr)
        return 1
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   spec=spec, cell=cell)
    print(f"card (name, power limit, SM clock, max SM clock, temperature) "
          f"after the run: {card_line()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"no result: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 1
    for k, c in out["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
