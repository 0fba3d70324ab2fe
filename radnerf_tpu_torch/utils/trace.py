"""Spans at the program's layer boundaries and one registry of counters,
on the clock of torch.profiler, the program's one tracing system.

Tracing is on exactly while a torch.profiler records: the trainer's
--profile_steps, whose trace.json (the log dir's trace/) carries the
spans below, the benchmark's traced spans, or any
`torch.profiler.profile` a caller opens. There is no flag of its own.

`span(name)`: a `with` block at a layer boundary. Off, it returns one
shared no-op context (one C call and an attribute read). On, it enters
`torch.profiler.record_function(name)`, so the span shows in the same
trace as a `user_annotation` on the host timeline and a
`gpu_user_annotation` on the device's, and it keeps a record in a ring
of the last RING spans: an id, the name, the id of the span it opened
in (None for a root), the host start and end in epoch nanoseconds
(`time.time_ns()`), the syncs counted directly under it, and the base
of the profiler's Chrome trace when tracing started: a trace's `ts` is
(epoch ns - base) / 1000 us, the base being the epoch floored to
7,889,238-second intervals (Kineto's ChromeTraceBaseTime), so a record
converts onto the trace's clock without the trace.

`count(name, n)`: the counters, always on (plain ints):
- `launch.<kernel>`: each launch of a hand-written kernel
  (kernels.launch);
- `sync`: while tracing is on, each CUDA call that makes the host wait
  for the device. Tracing turns on PyTorch's sync debug mode
  (`torch.cuda.set_sync_debug_mode("warn")`, where CUDA is in use) and
  counts its "called a synchronizing CUDA operation" warnings instead of
  printing them; each one also counts on the innermost open span. The
  first span entered, or sync warning met, after the profiler stops puts
  the previous mode, warning filter and warning printer back (each where
  nothing else has replaced it since).

The spans (parents in brackets):
- `train.step` (a root: one a step of Trainer.fit_steps, its grid update
  included), `train.grid_update`, `train.batch` [train.step];
- `step.slice` (an accumulation slice's forward), `step.backward`,
  `step.allreduce` (more than one rank), `step.adam` [train.step];
- `render.gate`, `render.march`, `render.encode`, `render.mlp`,
  `render.composite` [step.slice, train.grid_update, test.chunk,
  test.iteration];
  `loss` (nerf_loss) [step.slice];
- `test.chunk` (a root: one a chunk of render_rays_chunked),
  `test.iteration` (one a march-loop iteration) [test.chunk];
- `sync.<site>` around each call on the training and test paths that
  waits for the device: `sync.test_alive` (the march loop's condition),
  `sync.total_samples` (a chunk's sample count), `sync.budget_util`
  (the adaptive budget's read), `sync.occ_bounds`, `sync.march_ratio`,
  `sync.march_dt` (host constants copied to the device).

Read with `records()`, `counters()`; `reset()` clears both.
"""

from __future__ import annotations

import collections
import contextlib
import time
import typing
import warnings

import torch

RING = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"
TRIMONTH_S = 7_889_238

_profiler_enabled = torch._C._autograd._profiler_enabled


class Record(typing.NamedTuple):
    """A span as the ring keeps it (end_ns 0 while it is open)."""
    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int
    syncs: int
    base_ns: int


def kineto_base_ns(epoch_ns: int) -> int:
    """The base of a Chrome trace exported at `epoch_ns`: the epoch
    floored to 7,889,238-second intervals, in ns."""
    return epoch_ns // 10**9 // TRIMONTH_S * TRIMONTH_S * 10**9


class _Tracer:
    """The process's ring of span records, its open spans, its counters,
    and what tracing changed (the sync debug mode, the warning filters)
    while it is on."""

    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.stack = []
        self.counters = {}
        self.next_id = 0
        self.active = False
        self.base_ns = 0
        self._filter = None
        self._show = None
        self._sync_mode = None

    def start(self) -> None:
        self.active = True
        self.base_ns = kineto_base_ns(time.time_ns())
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._filter = warnings.filters[0]
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        if torch.cuda.is_initialized():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        """Undo what start changed, where nothing has replaced it since
        (a test's or caller's own warning context may have)."""
        self.active = False
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
        if warnings.showwarning == self._on_warning:
            warnings.showwarning = self._show
        if self._filter in warnings.filters:
            warnings.filters.remove(self._filter)
        self._filter = self._show = None

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if not str(message).startswith(SYNC_WARNING):
            self._show(message, category, filename, lineno, file, line)
        elif not _profiler_enabled():
            self.stop()
        else:
            count("sync")
            if self.stack:
                self.stack[-1][5] += 1


_T = _Tracer()
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _T.stack
        rec = [_T.next_id, self.name, stack[-1][0] if stack else None,
               time.time_ns(), 0, 0, _T.base_ns]
        _T.next_id += 1
        _T.ring.append(rec)
        stack.append(rec)
        return self

    def __exit__(self, *exc):
        _T.stack.pop()[4] = time.time_ns()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A `with` block named `name`: recorded while a torch.profiler
    records, else a shared no-op."""
    if not _profiler_enabled():
        if _T.active:
            _T.stop()
        return _NOOP
    if not _T.active:
        _T.start()
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`."""
    _T.counters[name] = _T.counters.get(name, 0) + n


def records() -> list:
    """The ring's span records, oldest first (a parent before its
    children)."""
    return [Record(*r) for r in _T.ring]


def counters() -> dict:
    """A copy of the counters."""
    return dict(_T.counters)


def reset() -> None:
    """Forget every record and counter."""
    _T.ring.clear()
    _T.counters.clear()
