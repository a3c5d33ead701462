"""Host ms per traced teacher epoch inside the runner's device-to-host
reads (the program's `runner.host_read` spans): the host blocked on the
device. None for a program without spans."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    row = totals.get("runner.host_read")
    if ctx["role"] != "train" or not row or not ctx["calls"]:
        return None
    return row[1] / ctx["calls"]
