"""glnn_tpu_torch — the GLNN pipeline in PyTorch with CUDA kernels for
Hopper, ported from the JAX package `glnn_tpu` (which stays the reference).

Layering mirrors glnn_tpu (bottom-up):
  graph/     host ingest and the device graph (dst-sorted CSC + CSR)
  ops/       message passing: plain torch tier and the CUDA SpMM kernel
  nn/        layers and models (MLP, SAGE), JAX weight import
  sampling/  fanout neighbour sampling (Floyd tier, concat blocks)
  train/     sampled-SAGE and MLP epochs, evals, the four runners
  utils/     seeding, config, splits, logging
  distributed/ --n_shards: partitioners, the process group and its
             collectives, the halo-sharded graph (which brings its own op
             forms), data-parallel sampling, and the rank's placement
             that the runners take; nothing below imports it
  cli/       train_teacher / train_student entry points
It imports neither jax nor glnn_tpu.
"""

__version__ = "0.1.0"
