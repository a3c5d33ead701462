"""The models' forward passes, written from their published definitions.

Parameters are a dict keyed as `data.weight_spec` names them. Shared
rules: hidden blocks run linear or conv -> batch norm -> relu -> dropout;
the last layer is bare. Batch norm: biased batch variance to normalise,
the unbiased one into the running average (momentum 0.1, eps 1e-5).
Dropout keeps an entry where a uniform draw is >= p and scales it by
1 / (1 - p); its draws come from the run's generator, one [rows, width]
draw per hidden block.

* MLP: the dense layers alone.

A graph model's whole-graph forward is `reference/<model_name>.py`
(`forward`), found by `graph_forward`; a model without one has no
reference, and the check stops rather than follow another's.
"""

from __future__ import annotations

import torch

from gnnbench import find
from gnnbench.reference.precision import Precision

EPS = 1e-5
MOMENTUM = 0.1


def batch_norm(x, p, prefix, train):
    w, b = p[prefix + "weight"], p[prefix + "bias"]
    rm, rv = p[prefix + "running_mean"], p[prefix + "running_var"]
    xs = x.float()
    if not train:
        return (xs - rm) * torch.rsqrt(rv + EPS) * w + b
    n = torch.tensor(float(x.shape[0]), device=x.device)
    mean = xs.mean(dim=0)
    var = (xs - mean).square().mean(dim=0)
    with torch.no_grad():
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        rm.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
        rv.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
    return (xs - mean) * torch.rsqrt(var + EPS) * w + b


def dropout(h, rate, gen):
    if rate == 0.0:
        return h
    keep = torch.rand(h.shape, generator=gen, device=h.device) >= rate
    return h * keep.to(h.dtype) / (1.0 - rate)


def _hidden(h, p, recipe, l, train, gen):
    if recipe.get("norm_type", "none") == "batch":
        h = batch_norm(h, p, f"module.norms.{l}.", train)
    h = torch.relu(h)
    return dropout(h, recipe["dropout_ratio"], gen) if train else h


def mlp(p, recipe, x, train, gen, prec: Precision):
    h = x
    L = recipe["num_layers"]
    for l in range(L):
        h = prec.linear(h, p[f"module.layers.{l}.weight"],
                        p[f"module.layers.{l}.bias"])
        if l < L - 1:
            h = _hidden(h, p, recipe, l, train, gen)
    return h


def graph_forward(model_name: str):
    """`forward(p, recipe, graph, x, train, gen, prec)` of
    `reference/<model_name>.py`: a graph model's logits on the whole
    graph."""
    try:
        return find.module("reference", model_name).forward
    except FileNotFoundError:
        raise ValueError(f"gnnbench: no reference forward for model "
                         f"{model_name!r} (gnnbench/reference/"
                         f"{model_name}.py)") from None
