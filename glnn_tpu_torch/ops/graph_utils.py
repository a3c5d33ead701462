"""Graph-level utilities (`glnn_tpu/ops/graph_utils.py`).

* `feature_prop`: k hops of D^-1/2 A D^-1/2 X with the in-degrees, clamped
  to >= 1, on both sides of each hop (as the reference and the JAX package
  do). It powers the GA-MLP augmentation (`--feature_aug_k`). JAX sums each
  hop in f32 (`refops.copy_u_sum`, an XLA segment sum); here a CUDA tensor
  takes the `spmm_csr_f32` kernel, with the graph's hub-row plan built once
  and kept on the graph, and a CPU tensor its plain version, both f32, so
  no hop rounds a message to bf16.
* `compute_min_cut_loss`: tr(S^T A S) / tr(S^T D S) with S = exp(out),
  computed sparsely: tr(S^T A S) = sum over edges of <S[src], S[dst]>,
  tr(S^T D S) = sum_v in_deg(v) ||S_v||^2 (in-degrees count self-loops).
  Gathers and sums in f32, outside any kernel, as in JAX.
"""

from __future__ import annotations

import torch

from glnn_tpu_torch.ops import spmm_cuda


def feature_prop(feats: torch.Tensor, g, k: int) -> torch.Tensor:
    """k hops of symmetric-normalised propagation of f32 feats [N, F] over
    g (on feats' device)."""
    norm = torch.rsqrt(g.in_degrees.clamp(min=1.0))[:, None]
    plan = spmm_cuda.graph_f32_plan(g)
    h = feats
    for _ in range(k):
        h = spmm_cuda.csr_sum_f32(g.indptr, g.senders, (h * norm).contiguous(),
                                  g.n_nodes, plan) * norm
    return h


def compute_min_cut_loss(g, out_log_probs: torch.Tensor) -> torch.Tensor:
    """The min-cut loss of the soft assignment exp(out_log_probs) [N, C]."""
    s = torch.exp(out_log_probs.float())
    num = (s.index_select(0, g.senders) * s.index_select(0, g.receivers)).sum()
    den = (g.in_degrees[:, None] * s * s).sum()
    return num / den
