"""Layers with DGL-0.6.1-parity math (`glnn_tpu/nn/layers.py`).

* SAGEConvGCN: SAGEConv(aggregator_type="gcn"): for dst v,
  h~_v = (sum_{u in N_in(v)} h_u + h_v) / (deg_in(v) + 1); out = W h~ + b.
  With a compute `dtype` (bfloat16) the input, the neighbour sum and the
  dense product run in it while the parameters stay f32 (`linear`).
* BatchNorm1d: torch.nn.BatchNorm1d semantics plus a row mask, which
  torch's module does not take (ghost rows of sampled frontiers must not
  enter the statistics); with `group_sum` set (the sharded paths), the
  batch statistics are taken over the rows of every rank.
* GraphConv: norm='both', D^-1/2 A D^-1/2 X W + b with degrees clamped
  >= 1, optional activation; W is applied before the aggregation when
  in_dim > out_dim, after it otherwise (the same math, fewer flops).
* GATConv: per head e_uv = leaky_relu_0.2(a_l.Wh_u + a_r.Wh_v), alpha the
  softmax over v's in-edges, h'_v = sum alpha Wh_u; feat dropout on the
  input, attention dropout on alpha; no bias, no residual.
* appnp_propagate: k hops of h <- (1 - alpha) D^-1/2 A_drop D^-1/2 h
  + alpha h0, with per-edge dropout (zero, or 1 / (1 - p)) in training;
  each hop draws the whole graph's mask (`n_edges_global` edges) and keeps
  the graph's edges from `edge_base`: all of them on a Graph, the shard's
  slice on a halo shard, so the ranks' masks together are the
  single-device mask.
  Each hop is `ops.appnp_hop`: inside the SpMM's walk where it can
  (norms and teleport fused, the same numbers), else `gcn_norm_both` and
  the teleport; `ops.hop_counts` counts the hops by path. The hops run in
  a span `model.APPNP.propagate`, each hop's mask draw and weight in
  `model.APPNP.edge_drop` (recorded only under a profiler,
  utils/profiling.py).
* LayerNorm1d: torch.nn.LayerNorm over the feature axis.
* dropout: inverted dropout whose mask comes from an explicit generator;
  inside `global_rows(total, lo)` (a rank's forward over rows lo.. of a
  batch of `total` rows, which the rank's epochs open) it draws the whole
  batch's mask and keeps this rank's rows, so every rank draws alike and
  the ranks' masks together are the single-device mask.
* linear: an nn.Linear in a compute dtype, as flax's Dense(dtype=...).

The layers import nothing of the sharded package: a halo shard brings its
own op forms to the op surface (ops/__init__.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import Graph
from glnn_tpu_torch.nn import initializers as gi
from glnn_tpu_torch.utils.profiling import span


_GLOBAL_ROWS = None     # (total, lo) inside `global_rows`


@contextlib.contextmanager
def global_rows(total: int, lo: int):
    """Forwards inside run on rows lo.. of a batch of `total` rows."""
    global _GLOBAL_ROWS
    old, _GLOBAL_ROWS = _GLOBAL_ROWS, (int(total), int(lo))
    try:
        yield
    finally:
        _GLOBAL_ROWS = old


def dropout(h: torch.Tensor, p: float, training: bool,
            gen: torch.Generator | None = None) -> torch.Tensor:
    if not training or p == 0.0:
        return h
    if _GLOBAL_ROWS is None:
        keep = torch.rand(h.shape, generator=gen, device=h.device) >= p
    else:
        total, lo = _GLOBAL_ROWS
        keep = (torch.rand((total,) + tuple(h.shape[1:]), generator=gen,
                           device=h.device) >= p)[lo:lo + h.shape[0]]
    return h * keep.to(h.dtype) / (1.0 - p)


def linear(fc: nn.Linear, h: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """fc(h), or with a compute dtype the input, weight and bias cast to it
    (the parameters stay f32, and their gradients come back in f32), as
    flax's Dense(dtype=...) casts all three. The bias is added to the
    product rounded to the dtype, as flax adds it, not inside the matmul."""
    if dtype is None:
        return fc(h)
    out = F.linear(h.to(dtype), fc.weight.to(dtype))
    return out if fc.bias is None else out + fc.bias.to(dtype)


class SAGEConvGCN(nn.Module):
    """`data` is a full Graph, or a sampled block {"nbr_local", "valid",
    "self_local", "concat"} (glnn_tpu_torch.sampling). A concat block's
    input rows are [outputs, neighbours]: the neighbours of output i are
    rows n_out + i*K .. n_out + (i+1)*K, so it needs only static slices; a
    dedup block gathers rows nbr_local and self_local. On blocks the
    divisor is (#sampled real neighbours + 1), in x's dtype; on the full
    graph it is in_degrees + 1 in f32, which promotes a bf16 sum to f32 as
    in JAX."""

    def __init__(self, in_dim: int, out_dim: int,
                 gen: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.fc = gi.xavier_linear_(nn.Linear(in_dim, out_dim), math.sqrt(2.0),
                                    gen)

    def forward(self, data, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if not isinstance(data, dict):          # a Graph or a HaloGraph
            neigh = ops.copy_u_sum(data, x)
            h = (neigh + x) / (data.in_degrees[:, None] + 1.0)
        else:
            valid = data["valid"]
            n_out, k = valid.shape
            if data["concat"]:
                gathered = x[n_out:n_out + n_out * k].reshape(n_out, k,
                                                              x.shape[-1])
                h_self = x[:n_out]
            else:
                gathered = x[data["nbr_local"].long()]          # [V, K, F]
                h_self = x[data["self_local"].long()]
            mask = valid[..., None].to(x.dtype)
            neigh = (gathered * mask).sum(dim=1)
            deg = valid.sum(dim=1).to(x.dtype)
            h = (neigh + h_self) / (deg[:, None] + 1.0)
        return linear(self.fc, h, self.dtype)


class GraphConv(nn.Module):
    """`weight` is [in, out] as in DGL and the JAX kernel."""

    def __init__(self, in_dim: int, out_dim: int, activation=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        gi.xavier_zero_bias_(self.weight, self.bias, gen)

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[0] > self.weight.shape[1]:
            h = ops.gcn_norm_both(g, x @ self.weight)
        else:
            h = ops.gcn_norm_both(g, x) @ self.weight
        h = h + self.bias
        return h if self.activation is None else self.activation(h)


_PROPAGATE = span("model.APPNP.propagate")
_EDGE_DROP = span("model.APPNP.edge_drop")


def appnp_propagate(g: Graph, h: torch.Tensor, k: int, alpha: float,
                    edge_drop: float, training: bool = False,
                    gen: torch.Generator | None = None,
                    masks=None) -> torch.Tensor:
    """APPNPConv(k, alpha, edge_drop) after the MLP head. In training each
    hop keeps an edge with probability 1 - edge_drop: the [E] mask is
    drawn from `gen` in dst-sorted edge order (on a halo shard the whole
    graph's, of which it keeps its edges' slice), or is masks[i] when
    given (bool [E] per hop, the graph's or the shard's edges)."""
    h0 = h
    use_drop = training and edge_drop > 0.0
    total, lo = g.n_edges_global, g.edge_base
    with _PROPAGATE:
        for i in range(k):
            w = None
            if use_drop:
                with _EDGE_DROP:
                    keep = (masks[i] if masks is not None else
                            (torch.rand((total,), generator=gen,
                                        device=h.device)
                             >= edge_drop)[lo:lo + g.n_edges])
                    w = keep.to(h.dtype) / (1.0 - edge_drop)
            h = ops.appnp_hop(g, h, h0, w, alpha)
    return h


class GATConv(nn.Module):
    """One `ops.gat_attention` call between a bias-free Linear(in, H*D) and
    the optional activation; `attn_l`/`attn_r` are [H, D]."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, activation=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.out_dim = num_heads, out_dim
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.fc = nn.Linear(in_dim, out_dim * num_heads, bias=False)
        gi.xavier_normal_(self.fc.weight, math.sqrt(2.0), gen)
        self.attn_l = nn.Parameter(torch.empty(num_heads, out_dim))
        self.attn_r = nn.Parameter(torch.empty(num_heads, out_dim))
        gi.attn_vector_normal_(self.attn_l, gen=gen)
        gi.attn_vector_normal_(self.attn_r, gen=gen)

    def forward(self, g: Graph, x: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        h = dropout(x, self.feat_drop, self.training, gen)
        feat = self.fc(h).view(-1, self.num_heads, self.out_dim)
        out = ops.gat_attention(
            g, feat, self.attn_l, self.attn_r, slope=self.negative_slope,
            drop_rate=self.attn_drop if self.training else 0.0, gen=gen)
        return out if self.activation is None else self.activation(out)


class BatchNorm1d(nn.Module):
    """Biased batch variance to normalise, UNBIASED variance into the
    running average, momentum 0.1, eps 1e-5; statistics in f32. With `mask`,
    only the rows where it is true enter the statistics. `group_sum`, when
    set, is a differentiable sum over the ranks (`mesh.all_reduce_sum`):
    the count, the mean and the variance are then those of every rank's
    rows together (the halo path's n_pad rows, the data-parallel MLP's
    global batch), as the single-device forward takes them, up to
    rounding."""

    group_sum = None

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xs = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if self.group_sum is not None:
                n, mean, var = self._group_stats(xs, mask)
            elif mask is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = xs.mean(dim=0)
                var = (xs - mean).square().mean(dim=0)
            else:
                w = mask.float()[:, None]
                n = w.sum().clamp(min=1.0)
                mean = (xs * w).sum(dim=0) / n
                var = (w * (xs - mean).square()).sum(dim=0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        out = (xs - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return out.to(x.dtype)

    def _group_stats(self, xs, mask):
        """(count, mean, biased variance) over the rows of every rank, from
        one sum over the ranks of each rank's row count, sums and sums of
        squares, in f64: E[x^2] - E[x]^2 keeps f32's precision there, and
        the forward and the backward each take one collective."""
        f = xs.shape[1]
        w = (torch.ones_like(xs[:, :1]) if mask is None
             else mask.float()[:, None]).double()
        xd = xs.double() * w
        tot = self.group_sum(torch.cat([xd.sum(dim=0),
                                        (xd * xs.double()).sum(dim=0),
                                        w.sum(dim=0)]))
        n = tot[-1].clamp(min=1.0)
        mean = tot[:f] / n
        var = (tot[f:2 * f] / n - mean.square()).clamp(min=0.0)
        return n.float(), mean.float(), var.float()


class LayerNorm1d(nn.Module):
    """torch.nn.LayerNorm over the feature axis (eps 1e-5); takes and
    ignores a row mask so that both norms share one call."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def make_norm(norm_type: str, dim: int) -> nn.Module:
    if norm_type == "batch":
        return BatchNorm1d(dim)
    if norm_type == "layer":
        return LayerNorm1d(dim)
    raise ValueError(f"unknown norm_type {norm_type!r}")
