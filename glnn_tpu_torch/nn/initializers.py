"""Parameter inits with the distributions of `glnn_tpu/nn/initializers.py`,
drawn from an explicit torch.Generator (None: torch's global one).

* torch nn.Linear default: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  (the MLP layers, glnn_tpu/nn/models.py:38-44);
* DGL SAGEConv: xavier_uniform(gain=sqrt(2)) weight, torch-default bias
  (glnn_tpu/nn/layers.py:87);
* DGL GATConv: xavier_normal(gain=sqrt(2)) on fc, and on the attention
  vectors with fan_in = fan_out = D (glnn_tpu/nn/initializers.py:47-70);
* DGL GraphConv: xavier_uniform (gain 1) weight, zero bias
  (glnn_tpu/nn/layers.py:100-101).
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def torch_linear_(layer: nn.Linear, gen: torch.Generator | None = None) -> nn.Linear:
    bound = 1.0 / math.sqrt(layer.in_features)
    nn.init.uniform_(layer.weight, -bound, bound, generator=gen)
    nn.init.uniform_(layer.bias, -bound, bound, generator=gen)
    return layer


@torch.no_grad()
def xavier_linear_(layer: nn.Linear, gain: float,
                   gen: torch.Generator | None = None) -> nn.Linear:
    nn.init.xavier_uniform_(layer.weight, gain=gain, generator=gen)
    bound = 1.0 / math.sqrt(layer.in_features)
    nn.init.uniform_(layer.bias, -bound, bound, generator=gen)
    return layer


@torch.no_grad()
def xavier_zero_bias_(weight: torch.Tensor, bias: torch.Tensor,
                      gen: torch.Generator | None = None) -> None:
    """GraphConv: U(+-sqrt(6 / (fan_in + fan_out))) weight, zero bias."""
    nn.init.xavier_uniform_(weight, generator=gen)
    nn.init.zeros_(bias)


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, gain: float,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """N(0, gain^2 * 2 / (fan_in + fan_out)) on a Linear weight [out, in]."""
    return nn.init.xavier_normal_(weight, gain=gain, generator=gen)


@torch.no_grad()
def attn_vector_normal_(vec: torch.Tensor, gain: float = math.sqrt(2.0),
                        gen: torch.Generator | None = None) -> torch.Tensor:
    """xavier_normal for GAT attention vectors [H, D]: fan_in = fan_out = D,
    so std = gain * sqrt(2 / (D + D))."""
    fan = vec.shape[-1]
    return nn.init.normal_(vec, 0.0, gain * math.sqrt(2.0 / (fan + fan)),
                           generator=gen)
