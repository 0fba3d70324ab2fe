"""Device time by the program function that launched it, from a
torch.profiler trace in the Chrome format: a frozen copy of the method of
the program's examples/trace_step.py, which files an autograd backward op
under the forward op that created its node (the forward-backward flow
events), extended to kernels launched through ctypes outside any op (the
runtime launch's correlation id).

Every device operation (kernel, copy, fill) becomes an item (name,
start us, duration us, frames, backward): frames are the program's
Python functions that enclosed its launch, outermost first, and
backward says that it ran in autograd's backward of those frames.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

PKG = "radnerf_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function: "
HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver")


def load_trace(prof) -> list:
    """The profile's events in the Chrome trace format."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _port_frame(name: str) -> str | None:
    if PKG not in name:
        return None
    return name[name.index(PKG):]


def _flows(events):
    start, finish = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            side = start if e["ph"] == "s" else finish
            side[(e["pid"], e["tid"], e["ts"])] = e["id"]
    return start, finish


def attribute(events) -> tuple:
    """({External id: (frames, backward)} of ops, {correlation id:
    (frames, backward)} of runtime launches, [(start us, end us,
    innermost frame)] of the host's port frames)."""
    flow_start, flow_finish = _flows(events)
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS:
            threads[(e["pid"], e["tid"])].append(e)
    recs, fwd_frames, node_flow, frames_iv = [], {}, {}, []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if e["cat"] == "python_function":
                fr = _port_frame(e["name"])
                if fr is not None:
                    frames_iv.append((e["ts"], e["ts"] + e["dur"], fr))
            else:
                frames = tuple(f for f in (_port_frame(o["name"])
                                           for o in stack
                                           if o["cat"] == "python_function")
                               if f is not None)
                node = next((id(o) for o in reversed(stack)
                             if o["name"].startswith(BACKWARD)), None)
                key = (e["pid"], e["tid"], e["ts"])
                if e["cat"] == "cpu_op":
                    fid = flow_finish.get(key)
                    if fid is not None and node is not None:
                        node_flow.setdefault(node, fid)
                    fid = flow_start.get(key)
                    if fid is not None:
                        fwd_frames.setdefault(fid, frames)
                recs.append((e, frames, node))
            stack.append(e)
    by_ext, by_corr = {}, {}
    for e, frames, node in recs:
        backward = False
        fwd = fwd_frames.get(node_flow.get(node))
        if node is not None and fwd is not None:
            frames, backward = fwd + frames, True
        elif node is not None:
            backward = True
        args = e.get("args", {})
        if e["cat"] == "cpu_op" and args.get("External id"):
            by_ext.setdefault(args["External id"], (frames, backward))
        elif e["cat"] in ("cuda_runtime", "cuda_driver") and \
                args.get("correlation") is not None:
            by_corr[args["correlation"]] = (frames, backward)
    return by_ext, by_corr, frames_iv


def device_items(events) -> list:
    """Every device operation as (name, start us, dur us, frames,
    backward), in start order."""
    by_ext, by_corr, _ = attribute(events)
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        src = by_corr.get(args.get("correlation"))
        if src is None or not src[0]:
            src = by_ext.get(args.get("External id"), src or ((), False))
        out.append((e["name"], float(e["ts"]), float(e["dur"]), *src))
    out.sort(key=lambda it: it[1])
    return out


def busy_us(items) -> float:
    """The time in which some device operation ran (the union of their
    intervals)."""
    total, end = 0.0, float("-inf")
    for _, ts, dur, _, _ in items:
        a, b = max(ts, end), ts + dur
        if b > a:
            total += b - a
        end = max(end, b)
    return total


def idle_gaps(items, frames_iv, top: int = 10) -> list:
    """The longest gaps between device operations, each named by the
    innermost program function the host was in when it began:
    [(name, seconds)]."""
    gaps, end = [], None
    for _, ts, dur, _, _ in items:
        if end is not None and ts > end:
            gaps.append((ts - end, end))
        end = ts + dur if end is None else max(end, ts + dur)
    gaps.sort(reverse=True)
    out = []
    for length, at in gaps[:top]:
        inner = [(b - a, fr) for a, b, fr in frames_iv if a <= at < b]
        name = min(inner)[1] if inner else "(no program frame)"
        out.append((name.split(": ")[-1] if ": " in name else name,
                    length / 1e6))
    return out


def top_ops(items, top: int = 10) -> list:
    """The device operations that took most time: [(name, seconds)]."""
    by = collections.Counter()
    for name, _, dur, _, _ in items:
        by[name[:64]] += dur
    return [(n, us / 1e6) for n, us in by.most_common(top)]


def under(items, needle: str) -> float:
    """Device seconds of the items launched under a program frame whose
    name contains `needle`, forward or backward."""
    return sum(dur for _, _, dur, frames, _ in items
               if any(needle in f for f in frames)) / 1e6


def named(items, needle: str) -> float:
    """Device seconds of the items whose name contains `needle`."""
    return sum(dur for name, _, dur, _, _ in items if needle in name) / 1e6
