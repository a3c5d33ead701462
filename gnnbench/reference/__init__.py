"""The plain reference: PyTorch operations only, importing neither `jax`
nor `glnn_tpu` nor anything of `glnn_tpu_torch`.

It works out again what the port derives from the benchmark's inputs: the
dst-sorted graph from the handed edges (`graph`), the dropout masks
(`philox` and the generator draws, in the order `train` documents), the
forward and backward of each model and the Adam update (`models`,
`train`). `Precision` says in which precision it
computes: `EXACT` is the precision the configurations state, `CONTROL` the
nearest one below it, which the check has to refuse.
"""

from gnnbench.reference.precision import CONTROL, EXACT, Precision

__all__ = ["CONTROL", "EXACT", "Precision"]
