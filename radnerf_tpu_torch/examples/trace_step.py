"""Where the training step's device time goes, per kernel and per port
module (twin of examples/trace_step.py).

Runs the bench-config step (`profile_step.build_step`: one Adam update of
the whole batch) under torch.profiler with CPU and CUDA activity and
Python stacks, then prints:
  - the wall time per step and the device busy time per step (the sum of
    the device kernels' times: they run on one stream);
  - the top 40 device kernels by time per step, with their counts;
  - a rollup by the port function that launched them: the innermost
    radnerf_tpu_torch/ function around the launching op (the trace's
    Python-function events, read from its Chrome trace export). An op of
    autograd's backward goes under the port function that ran the
    forward op whose autograd node it belongs to, as "<function>
    (backward)": the trace's forward-backward flow events tie the node
    to that forward op. "(backward) <node>" is left for a node with no
    flow event or whose forward op ran outside the port, and
    "(csrc launch) <kernel>" for a hand-written kernel launched through
    ctypes outside any PyTorch op; the share of device time under
    neither a port function nor its backward is printed as unattributed.
On the CPU the same tables hold the host ops' self time, and the device
time is "not measured".

    python -m radnerf_tpu_torch.examples.trace_step [--batch 4096]
        [--budget_per_ray 96] [--impl brick3] [--union_factor 1.0]
        [--steps 6]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import torch

from .common import add_device_arg, device_line
from .profile_step import build_step

PKG = "radnerf_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function: "


def load_trace(prof) -> list:
    """The profile's events in the Chrome trace format (stable across
    PyTorch versions: ops, Python functions, kernels and the External id
    that ties a kernel to the op that launched it)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _port_frame(name: str) -> str | None:
    """The port function a Python-function event names, or None (another
    package, or the examples themselves)."""
    if PKG not in name or f"{PKG}examples/" in name:
        return None
    return name[name.index(PKG):]


def _flows(events) -> tuple[dict, dict]:
    """The forward-backward flow events ("cat": "fwdbwd"): each start sits
    on the forward op that created an autograd node, its finish (same id)
    on the node's op in the backward. Returns ({(pid, tid, ts) of a
    start: id}, {(pid, tid, ts) of a finish: id})."""
    start, finish = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            side = start if e["ph"] == "s" else finish
            side[(e["pid"], e["tid"], e["ts"])] = e["id"]
    return start, finish


def attribute_ops(events) -> tuple[dict, list]:
    """Per thread, a sweep over the nested op and Python-function events:
    ({External id: source} of every op, [(op name, self us, source)]).
    An op's source is its innermost enclosing port function; for an op of
    autograd's backward, "<port function> (backward)" of the forward op
    that created its node (the flow events), else "(backward) <node>";
    else "(none)"."""
    flow_start, flow_finish = _flows(events)
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                  "python_function"):
            threads[(e["pid"], e["tid"])].append(e)
    # ops: (op, source, id of its enclosing backward-node op or None);
    # node_flow: that op's id -> the flow id of the node it evaluates
    ops, fwd_src, node_flow = [], {}, {}
    child_us = collections.Counter()
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if e["cat"] == "cpu_op":
                src, node = None, None
                for o in reversed([*stack, e]):
                    if o["cat"] == "python_function":
                        src = _port_frame(o["name"])
                    elif o["name"].startswith(BACKWARD):
                        src = "(backward) " + o["name"][len(BACKWARD):]
                        node = id(o)
                    if src is not None:
                        break
                fid = flow_finish.get((e["pid"], e["tid"], e["ts"]))
                if fid is not None and node is not None:
                    node_flow.setdefault(node, fid)
                src = src or "(none)"
                fid = flow_start.get((e["pid"], e["tid"], e["ts"]))
                if fid is not None:
                    fwd_src.setdefault(fid, src)
                parent = next((o for o in reversed(stack)
                               if o["cat"] == "cpu_op"), None)
                if parent is not None:
                    child_us[id(parent)] += e["dur"]
                ops.append((e, src, node))
            stack.append(e)
    source, out = {}, []
    for e, src, node in ops:
        fwd = fwd_src.get(node_flow.get(node), "")
        if fwd.startswith(PKG):
            src = f"{fwd} (backward)"
        ext = e.get("args", {}).get("External id")
        if ext:
            source[ext] = src
        out.append((e["name"], e["dur"] - child_us[id(e)], src))
    return source, out


def device_items(events, source: dict) -> list:
    """(kernel name, us, source) of every kernel, copy and fill on the
    device; a kernel launched outside any op (the csrc kernels' ctypes
    launches outside a custom autograd function) is "(csrc launch)"."""
    return [(e["name"], e["dur"],
             source.get(e.get("args", {}).get("External id"))
             or f"(csrc launch) {e['name']}")
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def report(items, steps: int, what: str) -> dict:
    """Print the top 40 names and the rollup by source, per step."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_src = collections.Counter()
    for name, us, src in items:
        by_name[name][0] += us
        by_name[name][1] += 1
        by_src[src] += us
    total = sum(us for _, us, _ in items)
    print(f"\n== total {what} {total / 1e3 / steps:.1f} ms/step; top "
          f"{'kernels' if what == 'device' else 'ops'} ==")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:40]
    for name, (us, n) in top:
        print(f"{us / 1e3 / steps:7.2f} ms x{n // steps:4d} {name[:100]}")
    print("\n== by framework op path ==")
    for src, us in by_src.most_common(30):
        print(f"{us / 1e3 / steps:8.2f} ms  {src[:140]}")
    # under no port function, forward or backward
    loose = sum(us for src, us in by_src.items() if not src.startswith(PKG))
    print(f"unattributed: {loose / 1e3 / steps:.2f} ms/step "
          f"({100 * loose / max(total, 1e-9):.1f}% of the total)")
    return {"total_ms_per_step": total / 1e3 / steps,
            "unattributed_ms_per_step": loose / 1e3 / steps,
            "by_source_ms": {k: v / 1e3 / steps for k, v in by_src.items()}}


def run(batch: int = 4096, budget_per_ray: int = 96, impl: str = "brick3",
        union_factor: float = 1.0, steps: int = 6, device="cuda",
        log2_T: int = 19, grid_size: int = 128) -> dict:
    """Trace `steps` steps after 3 warmup steps and print the tables;
    return the wall and device time per step and the rollup."""
    from torch.profiler import ProfilerActivity, profile

    print(device_line(device), flush=True)
    s = build_step(batch, budget_per_ray, impl, union_factor, device,
                   log2_T, grid_size)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    for _ in range(3):
        loss = s["step"]()
    float(loss.detach())
    print(f"# warmup {time.perf_counter() - t0:.1f}s", flush=True)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities, with_stack=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = s["step"]()
        float(loss.detach())
        sync()
        wall = time.perf_counter() - t0
    print(f"# traced {steps} steps in {wall:.2f}s "
          f"({wall / steps * 1e3:.1f} ms/step wall)", flush=True)
    out = {"wall_ms_per_step": wall / steps * 1e3}
    events = load_trace(prof)
    source, host = attribute_ops(events)
    if cuda:
        out["device"] = report(device_items(events, source), steps,
                               "device")
        busy = out["device"]["total_ms_per_step"]
        print(f"\n# per step: wall {out['wall_ms_per_step']:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / out['wall_ms_per_step']:.1f}"
              f"%)")
    else:
        print("\n== total device time: not measured (a CPU run); the "
              "tables below hold host ops' self time ==")
        out["host"] = report(host, steps, "host")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--budget_per_ray", type=int, default=96)
    ap.add_argument("--impl", type=str, default="brick3")
    ap.add_argument("--union_factor", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=6)
    args = add_device_arg(ap).parse_args(argv)
    run(args.batch, args.budget_per_ray, args.impl, args.union_factor,
        args.steps, args.device)


if __name__ == "__main__":
    main()
