"""APPNP (Klicpera, Bojchevski and Guennemann, "Predict then Propagate",
ICLR 2019, arXiv 1810.05997) as GLNN's teacher runs it (DGL's
`APPNPConv(k, alpha, edge_drop)` after an MLP), written from its
definition: h0 = MLP(x) (`models.mlp`: linear, relu, dropout on hidden
blocks), then K hops of

    h <- (1 - alpha) D_in^-1/2 A_w D_out^-1/2 h + alpha h0,

degrees clamped >= 1. In training A_w keeps each edge with probability
1 - edge_drop and scales a kept one by 1 / (1 - edge_drop), a fresh [E]
mask at every hop; in evals A_w = A.

Precision, as the configuration states it: dense products f32 with TF32
off; a training hop forms each message bf16(x_u * w_e) from the f32
product and sums the messages in f32, and its backward forms each edge's
message to the source bf16(dh_v * w_e) and sums those in f32 (the
weighted SpMM's two walks); an eval hop quantises its input per column
(scale = absmax / 127, 1 for an all-zero column; q = round(x / scale)
half to even, clipped to +-127), sums the int8 rows exactly and
dequantises once (the runner's default int8 eval). `prec` lowers the
dense products and the training messages; the eval hops stay int8.

Random draws, in the port's order: the MLP's dropout mask (one
[rows, width] uniform draw per hidden block), then each hop's [E] uniform
draw over the graph's dst-sorted edges, an edge kept where it is
>= edge_drop.

Departures from DGL's `APPNPConv`: DGL scales both sides by in-degrees;
here the source side takes out-degrees (as the port's `gcn_norm_both`).
On a graph where every edge's reverse is present, as the benchmark's are,
the two are equal. Sums run in another order than the port's kernels.
"""

from __future__ import annotations

import torch

from gnnbench.reference.models import mlp
from gnnbench.reference.precision import Precision


def _segment_sum(values, index, n):
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add_(
        0, index, values)


class _WeightedSum(torch.autograd.Function):
    """out[v] = sum over v's in-edges e of round(x[src e] w[e]), f32 sums;
    the backward sums round(dout[dst e] w[e]) over each source's out-edges
    in f32."""

    @staticmethod
    def forward(ctx, x, w, graph, prec):
        ctx.save_for_backward(w)
        ctx.graph, ctx.prec = graph, prec
        msg = prec.round_message(x[graph.src] * w[:, None])
        return _segment_sum(msg, graph.dst, graph.n_nodes)

    @staticmethod
    def backward(ctx, dout):
        w, = ctx.saved_tensors
        graph, prec = ctx.graph, ctx.prec
        msg = prec.round_message(dout.float()[graph.dst] * w[:, None])
        return _segment_sum(msg, graph.src, graph.n_nodes), None, None, None


def quantized_sum(x, graph):
    """The int8 hop's sum: x quantised per column, the int8 rows summed
    exactly over each row's in-edges, then dequantised."""
    scale = x.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / scale[None, :]), -127, 127)
    acc = _segment_sum(q.to(torch.int32)[graph.src], graph.dst,
                       graph.n_nodes)
    return acc.float() * scale[None, :]


def forward(p, recipe, graph, x, train, gen, prec: Precision):
    """APPNP logits on the whole graph."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k, alpha, drop = recipe["k"], recipe["alpha"], recipe["edge_drop"]
    src_norm = torch.rsqrt(graph.out_degrees.clamp(min=1.0))[:, None]
    dst_norm = torch.rsqrt(graph.in_degrees.clamp(min=1.0))[:, None]
    h0 = mlp(p, recipe, x, train, gen, prec)
    h = h0
    for _ in range(k):
        xs = h * src_norm
        if not train:
            prop = quantized_sum(xs, graph)
        else:
            w = torch.ones(graph.n_edges, device=x.device)
            if drop > 0.0:
                w = (torch.rand((graph.n_edges,), generator=gen,
                                device=x.device) >= drop).float() / (1.0 - drop)
            prop = _WeightedSum.apply(xs, w, graph, prec)
        h = (1.0 - alpha) * (prop * dst_norm) + alpha * h0
    return h
