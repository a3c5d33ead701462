"""Carry weights trained or initialised by the JAX package into the port."""

from __future__ import annotations

import numpy as np
import torch

from glnn_tpu_torch.nn.layers import BatchNorm1d
from glnn_tpu_torch.nn.models import GAT, GCN, MLP


@torch.no_grad()
def from_jax_variables(variables_np: dict, model) -> None:
    """Load a JAX `{"params", "batch_stats"}` tree of numpy arrays into the
    port's `Model` in place. A flax Dense kernel [in, out] becomes a
    Linear weight [out, in]; norm `scale`/`bias` become weight/bias, and
    BatchNorm `mean`/`var` the running statistics. A GAT layer
    (`convs_<i>`) carries a bias-free `Dense_0` kernel [in, H*D] and
    `attn_l`/`attn_r` [H, D]. A GCN layer (`GraphConv_<i>`) carries its
    kernel [in, out] as it is, and a bias; APPNP's tree is its MLP's
    (`Dense_<i>` and the norms)."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    m = model.module

    def put(dst: torch.Tensor, src) -> None:
        src = torch.from_numpy(np.array(src, np.float32))
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    if isinstance(m, GAT):
        for i, conv in enumerate(m.convs):
            p = params[f"convs_{i}"]
            put(conv.fc.weight, np.asarray(p["Dense_0"]["kernel"]).T)
            put(conv.attn_l, p["attn_l"])
            put(conv.attn_r, p["attn_r"])
        return
    # (weight seen as [in, out], bias, the flax kernel/bias dict)
    if isinstance(m, GCN):
        layers = [(c.weight, c.bias, params[f"GraphConv_{i}"])
                  for i, c in enumerate(m.convs)]
    elif isinstance(m, MLP):
        layers = [(lin.weight.T, lin.bias, params[f"Dense_{i}"])
                  for i, lin in enumerate(m.layers)]
    else:
        layers = [(c.fc.weight.T, c.fc.bias, params[f"SAGEConvGCN_{i}"]["Dense_0"])
                  for i, c in enumerate(m.convs)]
    for weight, bias, p in layers:
        put(weight, p["kernel"])
        put(bias, p["bias"])
    for i, norm in enumerate(m.norms or []):
        name = f"{'BatchNorm1d' if isinstance(norm, BatchNorm1d) else 'LayerNorm1d'}_{i}"
        put(norm.weight, params[name]["scale"])
        put(norm.bias, params[name]["bias"])
        if isinstance(norm, BatchNorm1d):
            put(norm.running_mean, stats[name]["mean"])
            put(norm.running_var, stats[name]["var"])
