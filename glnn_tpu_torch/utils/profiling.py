"""Profiling hooks (`glnn_tpu/utils/profiling.py`).

* `trace(log_dir, device)`: a context manager around `torch.profiler` that
  writes one Chrome trace (`*.pt.trace.json`, viewable in Perfetto or
  chrome://tracing) under `log_dir`; `utils/trace_report.py` reads it. It
  is not gzipped: a sampled SAGE epoch's trace holds tens of thousands of
  events, and compressing them would cost time in every traced run.
* `StepTimer`: host wall-clock accounting for epoch loops. The runners read
  a loss scalar inside each timed epoch, which waits for the device, so the
  mean covers the device work and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
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
