"""Share of the weighted walks' edges that they gathered over the traced
teacher epochs: 100 x gathered / walked from the program's
`spmm_cuda.gather_counts()`, which counts only while a profiler runs (the
walks skip the edges whose weight is 0: APPNP's edge drop). None for a
program without the counter, outside the train role, or where no weighted
walk ran."""

from glnn_tpu_torch.ops import spmm_cuda


def read(ctx):
    counts = getattr(spmm_cuda, "gather_counts", None)
    if ctx["role"] != "train" or counts is None:
        return None
    c = counts()
    if not c["walked"]:
        return None
    return 100.0 * c["gathered"] / c["walked"]
