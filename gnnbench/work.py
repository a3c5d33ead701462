"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work needs, and each model's work, found by its name.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
67 TFLOP/s f32 outside the tensor cores (the configurations' f32 with TF32
off), 989 TFLOP/s bf16, 3.35 TB/s of HBM.

Bytes of an op: each input read once and each output written once, in
the dtypes the op takes and gives (the kernels' own re-reads and partial
sums are not work). FLOPs: 2 per multiply-add of a dense product (its
backward: 2 for the weight gradient, 2 more for the input gradient where
one is needed), 1 per element of a sparse sum, and a fixed count per edge
and head for the attention arithmetic.

A model is `models/<model_name>.py`: `weight_spec(recipe, feat_dim,
label_dim)`, the laws its weights are drawn from, and for a model that an
epoch loop trains `epoch_flops(recipe, ds, n_edges)`, the FLOPs of one
runner epoch, and `epoch_ops(recipe, ds, n_edges)`, {kernel op: [(bytes,
flops) of each call in one epoch]}.
"""

from __future__ import annotations

from gnnbench import find

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float, dtype="float32") -> float:
    """The least time the work needs: the larger of its two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def model_work(model_name: str):
    """The module of `models/<model_name>.py`; a model without one has no
    weights or counted work, and the run stops rather than take
    another's."""
    try:
        return find.module("models", model_name)
    except FileNotFoundError:
        raise ValueError(f"gnnbench: no model file for {model_name!r} "
                         f"(gnnbench/models/{model_name}.py)") from None
