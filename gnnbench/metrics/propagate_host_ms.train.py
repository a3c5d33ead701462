"""Host ms per traced teacher epoch inside APPNP's propagation (the
program's `model.APPNP.propagate` spans, the train step's hops and the
eval's): the hops' launch path and mask draws, not their backward. None
for a program without the span."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    row = totals.get("model.APPNP.propagate")
    if ctx["role"] != "train" or not row or not ctx["calls"]:
        return None
    return row[1] / ctx["calls"]
