"""The traced part of a `--trace 1` run, reduced to what the per-layer
readers and the result's `breakdown` need.

`profile` runs a callable under `torch.profiler` (the host's ops and the
device's kernels, copies and sets), writes the Chrome trace to one fixed
file inside the checkout, reduces it and deletes it. The window is the
span from the first `ITER` annotation's start to the last one's end. Over
it: busy seconds (the union of the device's intervals, so overlapping ops
count once), the device time of each op by name, with the port's
hand-written kernels under the port's names (several kernels of one
split-row launch under one name), and the idle gaps between device
intervals, each put down to the innermost host op that covers its
midpoint.
"""

from __future__ import annotations

import collections
import heapq
import json
import re
from pathlib import Path

import torch

ITER = "gnnbench:iter"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

_NS = r"(?:\(anonymous namespace\)::)?"
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
NAME_CHARS = 100


_NOISE = re.compile(r"^void |\bat::native::|\(anonymous namespace\)::|"
                    r"\bstd::")


def port_name(name: str) -> str:
    """The port's name of its hand-written kernels; any other name with
    its namespaces dropped, cut to NAME_CHARS."""
    for pattern, port in PORT_KERNELS:
        if pattern.search(name):
            return port
    return _NOISE.sub("", name)[:NAME_CHARS]


def profile(run, device, path: Path) -> dict:
    """Trace `run()` (which wraps each iteration in
    `record_function(ITER)`) and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))
    try:
        size = path.stat().st_size
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    out = reduce(events, on_device=device.type == "cuda")
    out["trace_bytes"] = size
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, on_device: bool = True, top: int = 10) -> dict:
    """Seconds from a Chrome trace's events (timestamps in us)."""
    spans = [e for e in events if e.get("ph") == "X"]
    cat = [str(e.get("cat", "")).lower() for e in spans]
    dev_cats = DEVICE_CATS if on_device else ("cpu_op",)
    iters = [e for e, c in zip(spans, cat)
             if c == "user_annotation" and e.get("name") == ITER]
    if not iters:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "breakdown": None,
                "events": len(spans)}
    lo = min(float(e["ts"]) for e in iters)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in iters)
    dev, ops = [], collections.defaultdict(float)
    for e, c in zip(spans, cat):
        if c not in dev_cats:
            continue
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if t <= s:
            continue
        dev.append((s, t))
        ops[port_name(e.get("name", "?"))] += (t - s) / 1e6
    merged = _union(dev)
    busy = sum(t - s for s, t in merged) / 1e6
    gaps, at = [], lo
    for s, t in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e.get("name", "?"))
                  for e, c in zip(spans, cat)
                  if c in HOST_CATS and e.get("name") != ITER)
    by_host = collections.defaultdict(float)
    active, i = [], 0
    for s, t in sorted(gaps):
        mid = 0.5 * (s + t)
        while i < len(host) and host[i][0] <= mid:
            hs, he, name = host[i]
            heapq.heappush(active, (he - hs, he, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host op)"
        by_host[name[:NAME_CHARS]] += (t - s) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": (hi - lo) / 1e6, "ops": dict(ops),
            "breakdown": {"device_ops": rank(ops), "idle_gaps": rank(by_host)},
            "events": len(spans)}
