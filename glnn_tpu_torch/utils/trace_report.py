"""Where a path's device time goes: trace a callable with `utils.profiling
.trace` and aggregate the Chrome trace per op (`tools/trace_report.py`).

    from glnn_tpu_torch.utils.trace_report import trace_and_report
    res = trace_and_report(lambda: float(step()), torch.device("cuda:0"))
    res["rows"]          # [Row(name, count, total_ms, ms_per_iter), ...]
    res["idle_share"]    # 1 - busy / window over the traced calls

    python -m glnn_tpu_torch.utils.trace_report TRACE_OR_DIR [ITERS]

On a CUDA trace the ops are the device's events: its kernels, memcpys and
memsets. Each of the port's hand-written kernels is reported under the
port's name (`spmm_csr_bf16`, ..., `edge_softmax_bwd`; `port_name`), every
other kernel under its own demangled name. On a CPU trace the ops are the
host's `cpu_op` events. Beside the per-op table the report gives, over the
traced window: the busy time (the union of the ops' intervals, so
overlapping ops count once), the window's length (from the start of the
first traced call to the end of the last call or op) and the idle share,
1 - busy / window.
"""

from __future__ import annotations

import collections
import gzip
import json
import re
from pathlib import Path
from typing import NamedTuple

import torch

from glnn_tpu_torch.utils.profiling import trace

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "glnn_tpu_torch" / "traces"
# the annotation around each traced call of `trace_and_report`
ITER_SPAN = "trace_report:iter"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)

_NS = r"(?:\(anonymous namespace\)::)?"
# a demangled kernel name -> the port's kernel. Three SpMM kernels are one
# template, spmm_csr_kernel<P, VEC, HUB, H> (csrc/spmm_csr.cu), told apart
# by its policy P (APPNP's fused hops, H = Appnp<pass>, count under their
# policy's kernel). Where a CSR has hub rows split across warps, a kernel is
# several: the walk and the second pass that sums split rows' partials
# (spmm_csr_combine_kernel<P>, spmm_f32_combine_kernel), and for gat_fwd
# also the chunks' maxima before it (gat_fwd_max_kernel) and the sums
# after it (gat_fwd_combine_kernel); gat_bwd_kernel's chunk instantiation
# (the chunks' parts of t) before gat_bwd and gat_bwd_combine_kernel
# after it; the segment softmax's chunk maxima and sums
# (edge_softmax_hub_max_kernel, edge_softmax_hub_sum_kernel) before it,
# and its backward's chunks' parts of t (edge_softmax_bwd_hub_t_kernel)
# before edge_softmax_bwd_kernel. Each is counted as one launch of its port kernel (the wrappers count
# launches, not calls)
_WALK = r"\bspmm_csr_(?:combine_)?kernel<"
PORT_KERNELS = (
    (re.compile(rf"{_WALK}{_NS}Sum<__nv_bfloat16, float>"), "spmm_csr_bf16"),
    (re.compile(rf"{_WALK}{_NS}Sum<(?:signed char|int8_t|char), int>"),
     "spmm_csr_int8"),
    (re.compile(rf"{_WALK}{_NS}Weighted\b"), "spmm_csr_weighted"),
    (re.compile(r"\bspmm_f32_(?:combine_)?kernel\b"), "spmm_csr_f32"),
    (re.compile(r"\bgat_prep_kernel\b"), "gat_prep"),
    (re.compile(r"\bgat_fwd_(?:max_|combine_)?kernel\b"), "gat_fwd"),
    (re.compile(r"\bgat_bwd_(?:combine_)?kernel\b"), "gat_bwd"),
    (re.compile(r"\bedge_softmax_(?:fwd|hub_max|hub_sum)_kernel\b"),
     "edge_softmax_fwd"),
    (re.compile(r"\bedge_softmax_bwd_(?:hub_t_)?kernel\b"),
     "edge_softmax_bwd"),
)


class Row(NamedTuple):
    name: str
    count: int
    total_ms: float
    ms_per_iter: float


def port_name(name: str) -> str:
    """The port's name of a hand-written kernel; any other name as it is."""
    for pattern, port in PORT_KERNELS:
        if pattern.search(name):
            return port
    return name


def trace_and_report(run, device, iters: int = 3, out_dir=None,
                     top: int = 30, quiet: bool = False) -> dict:
    """One warm call of `run` outside the trace, then `iters` calls inside
    it, each under an `ITER_SPAN` annotation; returns `report` of the
    trace. `run` should wait for its own result (read a scalar) where the
    window should end with each call's device work."""
    run()
    with trace(DEFAULT_DIR if out_dir is None else out_dir, device) as t:
        for _ in range(iters):
            with torch.profiler.record_function(ITER_SPAN):
                run()
    return report(t.path, iters=iters, top=top, quiet=quiet)


def _trace_file(path_or_dir) -> Path:
    path = Path(path_or_dir)
    if path.is_file():
        return path
    found = [p for p in path.rglob("*.json*")
             if p.name.endswith((".json", ".json.gz"))]
    if not found:
        raise FileNotFoundError(f"no Chrome trace under {path}")
    return max(found, key=lambda p: (p.stat().st_mtime_ns, p.name))


def _load(path: Path) -> dict:
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _union_ms(spans) -> float:
    """Length of the union of (start, end) intervals, in ms (from us)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def report(path_or_dir, iters: int = 1, top: int = 30,
           quiet: bool = False) -> dict:
    """The per-op table of a Chrome trace (a file, or the newest under a
    directory): rows sorted by total time, and the busy ms, window ms and
    idle share of the ops."""
    path = _trace_file(path_or_dir)
    d = _load(path)
    spans = [e for e in d.get("traceEvents", []) if e.get("ph") == "X"]
    cat = [str(e.get("cat", "")).lower() for e in spans]
    on_device = bool(d.get("deviceProperties")) or any(
        c in DEVICE_CATS for c in cat)
    cats = DEVICE_CATS if on_device else HOST_CATS
    ops = [e for e, c in zip(spans, cat) if c in cats]
    marks = [e for e, c in zip(spans, cat)
             if c == "user_annotation" and e.get("name") == ITER_SPAN]

    def interval(e):
        ts = float(e["ts"])
        return ts, ts + float(e.get("dur", 0.0))

    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in ops:
        row = rows[port_name(e.get("name", "?"))]
        row[0] += 1
        row[1] += float(e.get("dur", 0.0)) / 1e3
    n = max(iters, 1)
    table = sorted((Row(name, c, t, t / n) for name, (c, t) in rows.items()),
                   key=lambda r: (-r.total_ms, r.name))
    intervals = [interval(e) for e in ops]
    bounds = [interval(e) for e in marks or ops] + intervals
    window = (max(e for _, e in bounds) - min(s for s, _ in bounds)) / 1e3 \
        if bounds else 0.0
    busy = _union_ms(intervals)
    total = sum(r.total_ms for r in table)
    out = {"path": str(path), "device": "cuda" if on_device else "cpu",
           "iters": iters, "rows": table, "total_ms_per_iter": total / n,
           "busy_ms": busy, "window_ms": window,
           "idle_share": 1.0 - busy / window if window > 0 else None}
    if not quiet:
        kind = "device" if on_device else "host (CPU trace)"
        print(f"# {path}")
        print(f"# {kind} ops: {total:.3f} ms over {iters} iters = "
              f"{total / n:.3f} ms/iter; busy {busy:.3f} ms of a "
              f"{window:.3f} ms window, idle share "
              f"{out['idle_share'] if window > 0 else '--'}")
        print(f"{'op':60s} {'n':>6s} {'total ms':>10s} {'ms/iter':>9s}")
        for r in table[:top]:
            print(f"{r.name[:60]:60s} {r.count:6d} {r.total_ms:10.3f} "
                  f"{r.ms_per_iter:9.3f}")
    return out


if __name__ == "__main__":
    import sys

    report(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR,
           iters=int(sys.argv[2]) if len(sys.argv) > 2 else 1)
