"""Profiling hooks (`glnn_tpu/utils/profiling.py`).

* `trace(log_dir, device)`: a context manager around `torch.profiler` that
  writes one Chrome trace (`*.pt.trace.json`, viewable in Perfetto or
  chrome://tracing) under `log_dir`; `utils/trace_report.py` reads it. It
  is not gzipped: a sampled SAGE epoch's trace holds tens of thousands of
  events, and compressing them would cost time in every traced run.
* `StepTimer`: host wall-clock accounting for epoch loops. The runners read
  a loss scalar inside each timed epoch, which waits for the device, so the
  mean covers the device work and not only its enqueueing.
* `span(name)`: the program's own spans (runners, model layers, kernel
  wrappers, plan builds), recorded only while a profiler runs. Made once
  per name, entered with `with`. With no profiler running a span costs one
  `_profiler_enabled()` call and nothing else; under one it is a
  `record_function` (a `user_annotation` in the Chrome trace, mirrored on
  the device's timeline as `gpu_user_annotation`) and a `SpanRecord` in an
  in-memory list, which `span_totals()` sums and `clear_spans()` empties.
  Nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import socket
import threading
import time
from pathlib import Path

import torch


@dataclasses.dataclass
class Trace:
    """What `trace` yields: `path`, the written trace, set on exit."""
    path: Path | None = None


@contextlib.contextmanager
def trace(log_dir, device):
    """Profile the block on `device` and write its Chrome trace under
    `log_dir`. A CUDA device records the host's ops and the device's
    kernels, copies and sets (`ProfilerActivity.CPU` and `.CUDA`); the CPU
    records its ops only. Asking for CUDA where no CUDA device is present
    raises: a trace never quietly leaves out the device."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace on {device}: no CUDA device is "
                               f"available")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif device.type != "cpu":
        raise ValueError(f"trace: no profiler activity for {device}")
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    out = Trace()
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out.path = log_dir / (f"{socket.gethostname()}_{os.getpid()}."
                          f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(str(out.path))


class StepTimer:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


# ---- spans ----------------------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
SPAN_CAP = 1 << 20


def recording() -> bool:
    """True while a profiler runs: spans record, and the kernel wrappers
    count what only a traced run reads (`spmm_cuda.gather_counts`)."""
    return _profiler_enabled()


@dataclasses.dataclass(slots=True, eq=False)
class SpanRecord:
    """One span: `parent` is the id of the span open around it on the same
    thread (-1: none), `root` the id of its top-level call's span, which a
    span opened on a thread with no span of its own (autograd's device
    thread in `loss.backward()`) takes from the thread that has one open.
    `end_ns` is 0 while the span is open."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    thread: int
    id: int


class SpanLog:
    """The records of every span opened under a profiler, at most `cap`;
    past that they are dropped and counted in `dropped`."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self._ids = itertools.count()
        self._local = threading.local()
        self._roots: dict[int, int] = {}   # thread -> its open root's id

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str):
        """Enter `record_function(name)` and start a record; returns what
        `close` takes."""
        tid = threading.get_ident()
        stack = self._stack()
        rid = next(self._ids)
        if stack:
            parent, root = stack[-1].id, stack[-1].root
        else:
            lent = [r for t, r in list(self._roots.items()) if t != tid]
            parent, root = -1, (lent[-1] if lent else rid)
            if root == rid:
                self._roots[tid] = rid
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        rec = SpanRecord(name, time.perf_counter_ns(), 0, parent, root, tid,
                         rid)
        stack.append(rec)
        if len(self.records) < self.cap:
            self.records.append(rec)
        else:
            self.dropped += 1
        return rec, rf

    def close(self, opened) -> None:
        rec, rf = opened
        rec.end_ns = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        stack = self._stack()
        stack.remove(rec)
        if not stack and self._roots.get(rec.thread) == rec.root:
            del self._roots[rec.thread]

    def totals(self) -> dict:
        """{name: (calls, total ms, self ms)} of the closed records; self
        time is a span's less the time its children on its thread
        cover."""
        covered = collections.Counter()
        for r in self.records:
            if r.end_ns and r.parent >= 0:
                covered[r.parent] += r.end_ns - r.start_ns
        out = {}
        for r in self.records:
            if not r.end_ns:
                continue
            d = r.end_ns - r.start_ns
            calls, total, own = out.get(r.name, (0, 0.0, 0.0))
            out[r.name] = (calls + 1, total + d / 1e6,
                           own + (d - covered[r.id]) / 1e6)
        return out

    def clear(self) -> None:
        self.records.clear()
        self.dropped = 0


_log = SpanLog()


class span:
    """A named span: `with s:` records the block while a profiler runs,
    and costs one `_profiler_enabled()` call otherwise; `s(fn)` wraps a
    function in it. Make one per name at import or construction time."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = []

    def __enter__(self):
        if _profiler_enabled():
            self._open.append(_log.open(self.name))

    def __exit__(self, exc_type, exc, tb):
        if self._open:
            _close_on_this_thread(self._open)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


def _close_on_this_thread(opened: list) -> None:
    tid = threading.get_ident()
    for i in range(len(opened) - 1, -1, -1):
        if opened[i][0].thread == tid:
            _log.close(opened.pop(i))
            return


def span_records() -> list[SpanRecord]:
    return list(_log.records)


def spans_dropped() -> int:
    return _log.dropped


def span_totals() -> dict:
    """{span name: (calls, total ms, self ms)} of the spans recorded since
    the last `clear_spans()`."""
    return _log.totals()


def clear_spans() -> None:
    _log.clear()
