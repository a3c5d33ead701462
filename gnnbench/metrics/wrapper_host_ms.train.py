"""Host ms per traced teacher epoch in the kernel wrappers themselves: the
self time of the program's `kernel.*` spans (plan checks, allocations,
launches), summed. None for a program without spans."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    own = [row[2] for name, row in totals.items() if name.startswith("kernel.")]
    if ctx["role"] != "train" or not own or not ctx["calls"]:
        return None
    return sum(own) / ctx["calls"]
