"""GAT (DGL GATConv), written from its published definition: per head
e_uv = leaky_relu_0.2(<a_l, Wh_u> + <a_r, Wh_v>), alpha = softmax over
v's in-edges, attention dropout on alpha, h'_v = sum alpha Wh_u; relu on
hidden layers, heads concatenated, the last layer's heads averaged.
Features and a_l enter the score and the messages rounded to the message
dtype (bf16), <a_r, Wh_v> is summed in f32 and rounded once to it, softmax
and sums are f32; the backward forms each per-edge message to the source
in the message dtype."""

from __future__ import annotations

import torch

from gnnbench.reference import philox
from gnnbench.reference.models import dropout
from gnnbench.reference.precision import Precision


def _segment_max(values, dst, n):
    h = values.shape[1]
    return values.new_zeros((n, h)).scatter_reduce_(
        0, dst[:, None].expand(-1, h), values, "amax", include_self=False)


def _segment_sum(values, dst, n):
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add_(
        0, dst, values)


class _Attention(torch.autograd.Function):
    """out[v,h] = sum_e alpha_eh feat_b[src e, h]; see the module note."""

    @staticmethod
    def forward(ctx, feat, attn_l, attn_r, graph, keep, inv_keep, slope,
                prec):
        src, dst, n = graph.src, graph.dst, graph.n_nodes
        fb = prec.round_message(feat)
        alb = prec.round_message(attn_l)
        el = (fb * alb[None]).sum(-1)
        er = prec.round_message((feat * attn_r[None]).sum(-1))
        s_pre = el[src] + er[dst]
        s = torch.where(s_pre >= 0, s_pre, slope * s_pre)
        w = (keep.float() * inv_keep if keep is not None
             else torch.ones_like(s))
        smax = _segment_max(s, dst, n)
        ex = torch.exp(s - smax[dst])
        denom = _segment_sum(ex, dst, n)
        alpha = ex / denom[dst]
        out = _segment_sum(fb[src] * (alpha * w)[..., None], dst, n)
        ctx.save_for_backward(feat, attn_r, fb, alb, s_pre, alpha, w)
        ctx.graph, ctx.slope, ctx.prec = graph, slope, prec
        return out

    @staticmethod
    def backward(ctx, dout):
        feat, attn_r, fb, alb, s_pre, alpha, w = ctx.saved_tensors
        graph, slope, prec = ctx.graph, ctx.slope, ctx.prec
        src, dst, n = graph.src, graph.dst, graph.n_nodes
        go = dout.float()[dst]
        fbs = fb[src]
        g = (fbs * go).sum(-1)
        t = _segment_sum(alpha * w * g, dst, n)
        ds = alpha * (w * g - t[dst])
        ds_pre = torch.where(s_pre >= 0, ds, slope * ds)
        der = _segment_sum(ds_pre, dst, n)
        msg = prec.round_message((alpha * w)[..., None] * go
                                 + ds_pre[..., None] * alb[None])
        dattn_l = (ds_pre[..., None] * fbs).sum(0)
        dfeat = (_segment_sum(msg, src, n) + der[:, :, None] * attn_r[None])
        dattn_r = torch.einsum("nh,nhd->hd", der, feat.float())
        return dfeat, dattn_l, dattn_r, None, None, None, None, None


def forward(p, recipe, graph, x, train, gen, prec: Precision):
    """GAT logits on the whole graph. In training each layer draws its
    feature-dropout mask, then one int64 seed (below 2**63 - 1) from which
    the attention's keep bits follow (`philox.keep_mask`)."""
    L = recipe["num_layers"]
    feat_drop = recipe["dropout_ratio"]
    attn_drop = recipe["attn_dropout_ratio"] if train else 0.0
    h = x
    for l in range(L):
        w = p[f"module.convs.{l}.fc.weight"]
        al, ar = p[f"module.convs.{l}.attn_l"], p[f"module.convs.{l}.attn_r"]
        heads, d = al.shape
        if train:
            h = dropout(h, feat_drop, gen)
        feat = prec.linear(h, w).view(-1, heads, d)
        keep, inv_keep = None, 1.0 / (1.0 - attn_drop)
        if attn_drop > 0.0:
            seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                                 generator=gen, device=x.device)
            keep = philox.keep_mask(seed, graph.n_edges, heads,
                                    1.0 / inv_keep)
        out = _Attention.apply(feat, al, ar, graph, keep, inv_keep, 0.2, prec)
        if l < L - 1:
            h = torch.relu(out).reshape(out.shape[0], -1)
        else:
            h = out.mean(dim=1)
    return h
