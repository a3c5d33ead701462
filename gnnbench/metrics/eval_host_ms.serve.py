"""Host ms per traced request inside the student's eval call (the
program's `runner.eval` span): the forward's host path, without the
client's gather, copies and wait. None for a program without spans."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    row = totals.get("runner.eval")
    if ctx["role"] != "serve" or not row or not ctx["calls"]:
        return None
    return row[1] / ctx["calls"]
