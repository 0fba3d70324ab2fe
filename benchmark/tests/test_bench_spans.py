"""The six readers of the program's spans on records and device items
worked by hand: host ms outside the sync.* spans, syncs, and the share
of idle time in gaps that begin inside a sync.* span; nothing read where
the roots do not line up with the items, where the span holds more
roots than were recorded, or where the program keeps no records."""

from __future__ import annotations

import sys

import pytest

from tiny import SPEC, run  # noqa: F401  (puts the repo on sys.path)

from radnerf_tpu_torch.utils import trace

BASE = 10 ** 18           # the records' trace base, epoch ns
MS = 10 ** 6

METRICS = {m["name"]: m for m in SPEC["per_layer"]}
KIND = {"train": ("train.step", "steps"), "render": ("test.chunk", "chunks")}


def _records(root: str, earlier: int = 0) -> list:
    """Two roots of 10 ms at 0 and 10 ms (and `earlier` roots before
    them): the first holds a sync.* span of 2 ms and two syncs inside a
    render span, the second one of 1 ms and one sync."""
    recs, i = [], 0

    def rec(name, parent, a_ms, b_ms, syncs=0):
        nonlocal i
        recs.append(trace.Record(i, name, parent, BASE + int(a_ms * MS),
                                 BASE + int(b_ms * MS), syncs, BASE))
        i += 1
        return i - 1

    for k in range(earlier, 0, -1):
        rec(root, None, -10 * k, -10 * k + 9)
    a = rec(root, None, 0, 10)
    m = rec("render.march", a, 1, 7)
    rec("sync.march_ratio", m, 4, 6, syncs=2)
    b = rec(root, None, 10, 20)
    rec("render.mlp", b, 10.5, 11)
    rec("sync.test_alive", b, 12, 13, syncs=1)
    return recs


def _items() -> list:
    """Device items (name, start us, us, frames, backward): idle 1700 us
    from inside the first sync span, 100 us outside any, 1200 us from
    inside the second."""
    return [(f"k{j}", ts, dur, (), False) for j, (ts, dur) in enumerate(
        [(500, 4000), (6200, 3000), (9300, 3000), (13500, 5000)])]


def _ctx(kind: str) -> dict:
    return {"span": {"items": _items(), "window_s": 0.02,
                     KIND[kind][1]: 2}}


def _read(name: str, ctx: dict):
    return run.read_metric(METRICS[name], ctx)


READINGS = {"host_issue_ms_per_step.train": 8.5,
            "host_syncs_per_step.train": 1.5,
            "sync_idle_share.train": 100 * 2900 / 3000,
            "host_issue_ms_per_chunk.render": 8.5,
            "host_syncs_per_chunk.render": 1.5,
            "sync_idle_share.render": 100 * 2900 / 3000}


@pytest.mark.parametrize("name", sorted(READINGS))
@pytest.mark.parametrize("earlier", [0, 2])
def test_readers_read_the_span_roots(name, earlier, monkeypatch):
    kind = name.rsplit(".", 1)[1]
    monkeypatch.setattr(trace, "records",
                        lambda: _records(KIND[kind][0], earlier))
    assert _read(name, _ctx(kind)) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_read_nothing_where_the_roots_do_not_fit(name, monkeypatch,
                                                          capsys):
    kind = name.rsplit(".", 1)[1]
    root, count = KIND[kind]
    monkeypatch.setattr(trace, "records", lambda: _records(root))
    ctx = _ctx(kind)
    ctx["span"][count] = 3                  # more roots than recorded
    assert _read(name, ctx) is None
    ctx = _ctx(kind)                         # the device ends too late
    ctx["span"]["items"].append(("late", 45_000, 10, (), False))
    assert _read(name, ctx) is None
    ctx = _ctx(kind)                         # the first item in no root
    ctx["span"]["items"].insert(0, ("early", -500, 10, (), False))
    assert _read(name, ctx) is None
    monkeypatch.setattr(trace, "records", lambda: _records("other.root"))
    assert _read(name, _ctx(kind)) is None
    assert capsys.readouterr().err.count("\n") == 4


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_read_nothing_from_a_program_without_spans(name,
                                                            monkeypatch):
    import radnerf_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "radnerf_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace")
    assert _read(name, _ctx(name.rsplit(".", 1)[1])) is None
