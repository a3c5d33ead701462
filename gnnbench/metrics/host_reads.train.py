"""The runner's device-to-host reads per traced teacher epoch (calls of the
program's `runner.host_read` span: the loss and the metrics row's six).
None for a program without spans."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    row = totals.get("runner.host_read")
    if ctx["role"] != "train" or not row or not ctx["calls"]:
        return None
    return row[0] / ctx["calls"]
