"""The f32 plain tier of the message-passing ops (`glnn_tpu/ops/refops.py`):
the oracle the kernels are held against and the path for CPU tensors."""

from __future__ import annotations

import torch

from glnn_tpu_torch.graph.container import Graph
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids


def copy_u_sum(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """h_v = sum_{u in N_in(v)} x_u (GSpMM copy_u -> sum), in x's dtype."""
    out = x.new_zeros((g.n_nodes,) + tuple(x.shape[1:]))
    return out.index_add_(0, g.receivers, x.index_select(0, g.senders))


def csr_sum_f32(indptr: torch.Tensor, indices: torch.Tensor, x: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Plain version of the spmm_csr_f32 kernel: out[v] = sum over
    indptr[v]:indptr[v+1] of x[indices[e]], an f32 segment sum."""
    note_plain(x)
    msgs = x.index_select(0, indices[: int(indptr[n_rows])])
    out = x.new_zeros((n_rows, x.shape[1]))
    return out.index_add_(0, row_ids(indptr, n_rows), msgs)


def copy_u_mean(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """h_v = mean over in-neighbours (degree-0 rows -> 0)."""
    return copy_u_sum(g, x) / g.in_degrees.clamp(min=1.0)[:, None]


def u_mul_e_sum(g: Graph, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """h_v = sum_u e_uv * x_u; e is per edge, [E] or [E, H] (per-head
    weights, broadcast over the features of x [N, H, D])."""
    msgs = x.index_select(0, g.senders)
    if e.dim() == msgs.dim() - 1:
        e = e[..., None]
    out = msgs.new_zeros((g.n_nodes,) + tuple(msgs.shape[1:]))
    return out.index_add_(0, g.receivers, msgs * e)


def degree_norms(g: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """(src_norm, dst_norm) = rsqrt of g's out- and in-degrees clamped
    >= 1, computed at the first call and kept in `g.cache` (a Graph or a
    halo shard; a moved or replaced one computes its own): the degrees
    never change, so every hop reads the same bits."""
    if "degree_norms" not in g.cache:
        g.cache["degree_norms"] = (torch.rsqrt(g.out_degrees.clamp(min=1.0)),
                                   torch.rsqrt(g.in_degrees.clamp(min=1.0)))
    return g.cache["degree_norms"]


def gcn_norm_both(g: Graph, x: torch.Tensor,
                  edge_weight: torch.Tensor | None = None,
                  sum_fn=copy_u_sum, wsum_fn=u_mul_e_sum) -> torch.Tensor:
    """D^-1/2 A D^-1/2 x (GraphConv norm='both'): out-degree norm on the
    source side, in-degree norm on the destination side, both clamped
    >= 1 (`degree_norms`); `edge_weight` [E] optionally scales the
    messages (APPNP's edge drop). `sum_fn` / `wsum_fn` take the plain f32
    sums' place (the dispatcher passes its tiered ones)."""
    src_norm, dst_norm = degree_norms(g)
    h = x * src_norm[:, None]
    h = sum_fn(g, h) if edge_weight is None else wsum_fn(g, h, edge_weight)
    return h * dst_norm[:, None]


def u_add_v(g: Graph, a_u: torch.Tensor, a_v: torch.Tensor) -> torch.Tensor:
    """Per-edge score a_u[src] + a_v[dst] (the GAT SDDMM)."""
    return a_u.index_select(0, g.senders) + a_v.index_select(0, g.receivers)


def edge_softmax(g: Graph, scores: torch.Tensor) -> torch.Tensor:
    """Softmax over each destination's in-edge segment; scores [E] or
    [E, H]."""
    return segment_softmax(g.receivers, g.n_nodes, scores)


def segment_softmax(dst: torch.Tensor, n_rows: int,
                    scores: torch.Tensor) -> torch.Tensor:
    """Softmax of scores [E] or [E, H] over the edges of each of n_rows
    rows, dst each edge's row. The per-row max is subtracted (a constant
    per segment, so it carries no gradient); rows without edges are never
    gathered back."""
    dst = dst.long()
    shape = (n_rows,) + tuple(scores.shape[1:])
    idx = dst.view((-1,) + (1,) * (scores.dim() - 1)).expand_as(scores)
    with torch.no_grad():
        seg_max = scores.new_zeros(shape).scatter_reduce_(
            0, idx, scores, "amax", include_self=False)
    expv = torch.exp(scores - seg_max.index_select(0, dst))
    seg_sum = expv.new_zeros(shape).index_add_(0, dst, expv)
    return expv / seg_sum.index_select(0, dst)
