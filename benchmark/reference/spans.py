"""The program's own spans in a cell's traced span (without stacks): the
span records of radnerf_tpu_torch/utils/trace.py, read from the program
after the run.

A record is (id, name, parent, start_ns, end_ns, syncs, base_ns): host
epoch ns, the syncs counted directly under it, and the base of the
profiler's Chrome trace, so that its time on the trace's clock is
(ns - base_ns) / 1000 us. A span's roots are the `n` roots of their
name from the one in which the span's first device item starts (in a
run of a cell, the traced span without stacks runs first: the first n
roots the program recorded); they are taken only where the span's last
device item ends within one root's share of the span's wall time after
the last of them ends.

Everything here works on the records and items handed in; a program
that keeps no records (no utils/trace.py) gives no selection, and the
readers then report nothing.
"""

from __future__ import annotations

import bisect
import sys

SYNC = "sync."


def program_records():
    """The program's span records, or None where it keeps none."""
    try:
        from radnerf_tpu_torch.utils import trace
    except ImportError as e:
        print(f"no span records in the program: {e}", file=sys.stderr)
        return None
    return trace.records()


def _us(ns: int, base_ns: int) -> float:
    return (ns - base_ns) / 1e3


def select(records, span: dict, root: str, n: int):
    """The span's n roots named `root` and the records under them, as
    {"roots", "members"}, where they line up with the span's device
    items; else None, with the reason on stderr."""
    if records is None:
        return None
    items = span["items"]
    if not items:
        print("the span has no device items", file=sys.stderr)
        return None
    t0 = items[0][1]
    t1 = max(ts + dur for _, ts, dur, _, _ in items)
    named = [r for r in records if r.parent is None and r.name == root]
    at = next((i for i, r in enumerate(named)
               if _us(r.start_ns, r.base_ns) <= t0
               <= _us(r.end_ns, r.base_ns)), None)
    if at is None:
        print(f"no {root} root of {len(named)} holds the span's first "
              f"device item ({t0:.1f} us on the trace's clock)",
              file=sys.stderr)
        return None
    roots = named[at:at + n]
    last = roots[-1]
    if len(roots) < n or t1 > _us(last.end_ns, last.base_ns) + \
            span["window_s"] * 1e6 / n:
        print(f"{len(roots)} {root} roots from the span's first, of {n}, "
              f"the last ending at {_us(last.end_ns, last.base_ns):.1f} "
              f"us; the span's last device item ends at {t1:.1f} us",
              file=sys.stderr)
        return None
    ids = {r.id for r in roots}
    members = list(roots)
    for r in records:
        if r.parent in ids and r.id not in ids:
            ids.add(r.id)
            members.append(r)
    return {"roots": roots, "members": members}


def _outer_syncs(members) -> list:
    """The sync.* records under no other sync.* record."""
    by_id = {r.id: r for r in members}
    out = []
    for r in members:
        if not r.name.startswith(SYNC):
            continue
        p = by_id.get(r.parent)
        while p is not None and not p.name.startswith(SYNC):
            p = by_id.get(p.parent)
        if p is None:
            out.append(r)
    return out


def host_issue_ms(sel) -> float:
    """Mean host ms of a root outside the sync.* spans under it."""
    waits = _outer_syncs(sel["members"])
    total = sum(r.end_ns - r.start_ns for r in sel["roots"])
    total -= sum(r.end_ns - r.start_ns for r in waits)
    return total / 1e6 / len(sel["roots"])


def syncs_per_root(sel) -> float:
    """Syncs counted under the roots, per root."""
    return sum(r.syncs for r in sel["members"]) / len(sel["roots"])


def sync_idle_share(sel, items):
    """The share, in %, of the device's idle time between the items that
    lies in gaps beginning while the host is inside a sync.* span; None
    (with the reason on stderr) where the device was never idle."""
    waits = sorted((_us(r.start_ns, r.base_ns), _us(r.end_ns, r.base_ns))
                   for r in _outer_syncs(sel["members"]))
    starts = [a for a, _ in waits]
    idle = in_sync = 0.0
    end = None
    for _, ts, dur, _, _ in items:
        if end is not None and ts > end:
            idle += ts - end
            k = bisect.bisect_right(starts, end) - 1
            if k >= 0 and end <= waits[k][1]:
                in_sync += ts - end
        end = ts + dur if end is None else max(end, ts + dur)
    if idle <= 0:
        print("the device was never idle in the span", file=sys.stderr)
        return None
    return 100.0 * in_sync / idle
