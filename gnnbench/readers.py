"""What the per-layer readers (`metrics/<metric>.py`) share.

A reader gets the run's context: `loop` and `role` (which loop ran),
`spans` (host seconds of each train-epoch and eval call of the traced
run's untraced part, each ended by the runner's own synchronise),
`trace` (`trace.reduce`'s summary of the traced part), `ops` (the bytes
and FLOPs of each kernel op's calls in one epoch), `calls` (epochs or
requests traced), `flops` and `elapsed_s` (the untraced part's work and
time) and `dtype`. It returns None where it finds nothing to read.
"""

from __future__ import annotations

from gnnbench import work


def mean_ms(ctx, loop: str, span: str):
    xs = ctx["spans"].get(span) if ctx["loop"] == loop else None
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_share(ctx, role: str):
    """Per cent of the traced window in which no device op ran."""
    t = ctx["trace"]
    if ctx["role"] != role or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_ms(ctx, role: str):
    """Device-busy ms per traced epoch or request: the union of the
    device's intervals over the calls traced."""
    t = ctx["trace"]
    if ctx["role"] != role or not t or t["busy_s"] <= 0 or not ctx["calls"]:
        return None
    return 1e3 * t["busy_s"] / ctx["calls"]


def roofline(ctx, kernel: str):
    """Per cent: the least time the op's traced calls need over the device
    time of every kernel it launched."""
    t, calls = ctx["trace"], ctx["ops"].get(kernel)
    if not t or not calls:
        return None
    seconds = t["ops"].get(kernel, 0.0)
    if seconds <= 0:
        return None
    least = sum(work.least_seconds(b, f, ctx["dtype"]) for b, f in calls)
    return 100.0 * least * ctx["calls"] / seconds


def mfu(ctx, role: str):
    """Per cent of the dtype's dense peak that the untraced part's counted
    FLOPs reach."""
    if ctx["role"] != role or not ctx.get("flops") or not ctx.get("elapsed_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["elapsed_s"]
                                   * work.PEAK_FLOPS[ctx["dtype"]])
