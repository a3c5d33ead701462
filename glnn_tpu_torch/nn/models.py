"""Model zoo of the port: MLP, SAGE, GCN, GAT and APPNP, and the
substring-dispatch wrapper (`glnn_tpu/nn/models.py`).

Contracts kept: every model returns `(h_list, h)` with the hidden states
before the norm (the fitnet hook); MLP, SAGE and APPNP hidden blocks run
linear/conv -> append h -> norm -> relu -> dropout, GCN hidden blocks run
conv (relu fused) -> append h -> norm -> dropout, GAT hidden blocks run
conv (relu per head) -> concatenate heads -> append; the last layer is
bare (GAT: mean over its heads; a 1-layer GCN keeps its relu); APPNP runs
its MLP, then k = 10 propagation hops with alpha 0.1 and edge drop 0.5;
the wrapper dispatches on a SUBSTRING of model_name, MLP first, so
"MLP3w4" and "GA1MLP" are MLPs.

conf["compute_dtype"] "bfloat16" sets the activation dtype of the MLP and
SAGE (`glnn_tpu/nn/models.py:38-118`): every layer casts its input to
bf16 and runs its dense product in bf16 with f32 parameters, the batch norm keeps f32
statistics and returns bf16, and the logits come out bf16 (the losses cast
them to f32). GCN, GAT and APPNP ignore it, as in JAX.

Each layer of a forward runs in a span `model.<Class>.layer<l>` (recorded
only under a profiler, utils/profiling.py); APPNP's are its MLP's layers,
and its hops run in `model.APPNP.propagate` (nn/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from glnn_tpu_torch.nn import initializers as gi
from glnn_tpu_torch.nn.layers import (
    GATConv,
    GraphConv,
    SAGEConvGCN,
    appnp_propagate,
    dropout,
    linear,
    make_norm,
)
from glnn_tpu_torch.utils.profiling import span

# conf compute_dtype -> the activation dtype (None: f32 throughout)
COMPUTE_DTYPES = {"float32": None, "f32": None, "bfloat16": torch.bfloat16}


def compute_dtype(conf: dict) -> torch.dtype | None:
    name = conf.get("compute_dtype") or "float32"
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def _layer_spans(model: nn.Module, num_layers: int) -> list:
    return [span(f"model.{type(model).__name__}.layer{l}")
            for l in range(num_layers)]


def _dims(num_layers, input_dim, hidden_dim, output_dim):
    dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
    return list(zip(dims[:-1], dims[1:]))


class MLP(nn.Module):
    def __init__(self, num_layers, input_dim, hidden_dim, output_dim,
                 dropout_ratio, norm_type="none", gen=None, dtype=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.dtype = dtype
        self.layers = nn.ModuleList(
            gi.torch_linear_(nn.Linear(i, o), gen)
            for i, o in _dims(num_layers, input_dim, hidden_dim, output_dim))
        self.norms = nn.ModuleList(
            make_norm(norm_type, hidden_dim) for _ in range(num_layers - 1)
        ) if norm_type != "none" else None
        self.spans = _layer_spans(self, num_layers)

    def forward(self, x, gen=None):
        h, h_list = x, []
        last = len(self.layers) - 1
        for l, layer in enumerate(self.layers):
            with self.spans[l]:
                h = linear(layer, h, self.dtype)
                if l != last:
                    h_list.append(h)
                    if self.norms is not None:
                        h = self.norms[l](h)
                    h = dropout(torch.relu(h), self.dropout_ratio,
                                self.training, gen)
        return h_list, h


class SAGE(nn.Module):
    """Takes a full Graph (all-neighbour forward) or SampledBlocks
    (fanout-sampled minibatch forward); both share the parameters."""

    def __init__(self, num_layers, input_dim, hidden_dim, output_dim,
                 dropout_ratio, norm_type="none", gen=None, dtype=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.dtype = dtype
        self.convs = nn.ModuleList(
            SAGEConvGCN(i, o, gen, dtype)
            for i, o in _dims(num_layers, input_dim, hidden_dim, output_dim))
        self.norms = nn.ModuleList(
            make_norm(norm_type, hidden_dim) for _ in range(num_layers - 1)
        ) if norm_type != "none" else None
        self.spans = _layer_spans(self, num_layers)

    def forward(self, g, x, gen=None):
        from glnn_tpu_torch.sampling.sampler import SampledBlocks

        blocks = isinstance(g, SampledBlocks)
        h, h_list = x, []
        last = len(self.convs) - 1
        for l, conv in enumerate(self.convs):
            with self.spans[l]:
                if blocks:
                    data = {"valid": g.valid[l], "concat": g.concat}
                    if not g.concat:
                        data.update(nbr_local=g.nbr_local[l],
                                    self_local=g.self_local[l])
                    mask = g.out_real[l]
                else:
                    data, mask = g, None
                h = conv(data, h)
                if l != last:
                    h_list.append(h)
                    if self.norms is not None:
                        h = self.norms[l](h, mask)
                    h = dropout(torch.relu(h), self.dropout_ratio,
                                self.training, gen)
        return h_list, h


class GCN(nn.Module):
    def __init__(self, num_layers, input_dim, hidden_dim, output_dim,
                 dropout_ratio, norm_type="none", gen=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        dims = _dims(num_layers, input_dim, hidden_dim, output_dim)
        # the single layer of a 1-layer GCN keeps its relu (reference
        # quirk, glnn_tpu/nn/models.py:135-139)
        self.convs = nn.ModuleList(
            GraphConv(i, o, None if (l == num_layers - 1 and num_layers > 1)
                      else torch.relu, gen)
            for l, (i, o) in enumerate(dims))
        self.norms = nn.ModuleList(
            make_norm(norm_type, hidden_dim) for _ in range(num_layers - 1)
        ) if norm_type != "none" else None
        self.spans = _layer_spans(self, num_layers)

    def forward(self, g, x, gen=None):
        h, h_list = x, []
        last = len(self.convs) - 1
        for l, conv in enumerate(self.convs):
            with self.spans[l]:
                h = conv(g, h)
                if l != last:
                    h_list.append(h)
                    if self.norms is not None:
                        h = self.norms[l](h)
                    h = dropout(h, self.dropout_ratio, self.training, gen)
        return h_list, h


class APPNP(MLP):
    """The MLP, then `appnp_propagate` over the graph; its edge-drop masks
    come from the forward's generator."""

    def __init__(self, num_layers, input_dim, hidden_dim, output_dim,
                 dropout_ratio, norm_type="none", gen=None, edge_drop=0.5,
                 alpha=0.1, k=10):
        super().__init__(num_layers, input_dim, hidden_dim, output_dim,
                         dropout_ratio, norm_type, gen)
        self.edge_drop, self.alpha, self.k = edge_drop, alpha, k

    def forward(self, g, x, gen=None):
        h_list, h = super().forward(x, gen)
        return h_list, appnp_propagate(g, h, self.k, self.alpha,
                                       self.edge_drop, self.training, gen)


class GAT(nn.Module):
    """Heads [num_heads] * (num_layers - 1) + [1]; hidden_dim is divided by
    num_heads (models.py:218-225); num_layers must exceed 1."""

    def __init__(self, num_layers, input_dim, hidden_dim, output_dim,
                 dropout_ratio, num_heads=8, attn_drop=0.3, gen=None):
        super().__init__()
        if num_layers < 2:
            raise ValueError("GAT requires num_layers > 1")
        per_head = hidden_dim // num_heads
        kw = dict(feat_drop=dropout_ratio, attn_drop=attn_drop, gen=gen)
        in_dims = [input_dim] + [per_head * num_heads] * (num_layers - 1)
        self.convs = nn.ModuleList(
            GATConv(in_dims[l], per_head, num_heads, activation=torch.relu,
                    **kw) for l in range(num_layers - 1))
        self.convs.append(GATConv(in_dims[-1], output_dim, 1, **kw))
        self.spans = _layer_spans(self, num_layers)

    def forward(self, g, x, gen=None):
        h, h_list = x, []
        last = len(self.convs) - 1
        for l, conv in enumerate(self.convs):
            with self.spans[l]:
                h = conv(g, h, gen)                    # [N, H, D]
                if l != last:
                    h = h.reshape(h.shape[0], -1)      # concatenate heads
                    h_list.append(h)
                else:
                    h = h.mean(dim=1)                  # average heads
        return h_list, h


class Model(nn.Module):
    """Substring-dispatch wrapper. `conf` needs model_name, num_layers,
    hidden_dim, feat_dim, label_dim and dropout_ratio; `gen` draws the
    initial weights."""

    def __init__(self, conf: dict, gen: torch.Generator | None = None):
        super().__init__()
        self.model_name = name = conf["model_name"]
        self.conf = conf
        cdtype = compute_dtype(conf)
        kw = dict(num_layers=conf["num_layers"], input_dim=conf["feat_dim"],
                  hidden_dim=conf["hidden_dim"], output_dim=conf["label_dim"],
                  dropout_ratio=conf["dropout_ratio"],
                  norm_type=conf.get("norm_type", "none"), gen=gen)
        if "MLP" in name:
            self.module = MLP(dtype=cdtype, **kw)
        elif "SAGE" in name:
            self.module = SAGE(dtype=cdtype, **kw)
        elif "GCN" in name:
            self.module = GCN(**kw)
        elif "GAT" in name:
            kw.pop("norm_type")
            self.module = GAT(num_heads=conf.get("num_heads", 8),
                              attn_drop=conf.get("attn_dropout_ratio", 0.3),
                              **kw)
        elif "APPNP" in name:
            self.module = APPNP(**kw)
        else:
            raise ValueError(f"Unknown model name: {name}")
        self.is_mlp = "MLP" in name

    def forward(self, g, feats, gen=None):
        """(h_list, h); the graph is ignored by MLPs."""
        if self.is_mlp:
            return self.module(feats, gen)
        return self.module(g, feats, gen)
