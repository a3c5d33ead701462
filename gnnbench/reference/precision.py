"""The precision a reference computation runs in.

The configurations state float32 dense products with TF32 off, and bf16
attention messages with f32 softmax and sums (the GAT layer). The control
lowers each part by one step: TF32 for the f32 products (inputs rounded to
TF32's 10-bit mantissa, products summed in f32, which is what the card's
TF32 mode computes; emulated so that it runs alike on every device), fp8
(e4m3) for the bf16 messages.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Precision:
    tf32: bool = False
    message_dtype: torch.dtype = torch.bfloat16

    def round_message(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to the message dtype, back in f32."""
        return x.to(self.message_dtype).float()

    def linear(self, x, weight, bias=None):
        """F.linear; under the control its three products (forward, input
        and weight gradients) take TF32-rounded operands."""
        if self.tf32:
            return _TF32Linear.apply(x, weight, bias)
        return F.linear(x, weight, bias)


class _TF32Linear(torch.autograd.Function):
    """x W^T + b as the card's TF32 mode computes it."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = tf32_round(x), tf32_round(weight)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = bias is not None
        out = xr @ wr.t()
        return out + bias if bias is not None else out

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = tf32_round(g)
        flat = gr.reshape(-1, gr.shape[-1])
        dw = flat.t() @ xr.reshape(-1, xr.shape[-1])
        db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gr @ wr, dw, db


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


EXACT = Precision()
CONTROL = Precision(tf32=True, message_dtype=torch.float8_e4m3fn)
