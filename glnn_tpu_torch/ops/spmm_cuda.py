"""CSR SpMM on the GPU: the hand-written CUDA kernel behind `copy_u_sum`.

Replaces the TPU kernels `glnn_tpu/ops/spmm_pallas.py:_block_kernel` (:93,
block mode) and `:_kernel` (:59, tiled mode): one segmented sum
H[v] = sum over in-edges e of v of x[src(e)], in two tiers.

* exact: x is cast to bf16 before the kernel (as spmm_pallas.py:244-250
  casts before its gather), the kernel sums the bf16 rows in f32, and the
  result is cast back to x's dtype (:258).
* int8: x is quantised per column (absmax / 127, round half to even; plain
  torch, since the quantisation lies outside the Pallas kernel too,
  :401-405), the kernel sums int8 rows in int32 (exact) and multiplies each
  column by its scale (:408-414).

The kernel (`csrc/spmm_csr.cu`) walks the dst-sorted CSC directly: a warp
owns a dst row and sums the gathered rows in registers, so there is no
one-hot, no message tensor and no atomics. It is bound by bytes on an H100
(the E * F * itemsize bytes of gathered rows, the indices, and the N * F * 4
bytes of output); its design keeps each lane's loads 16 bytes wide where F
allows and loads 32 indices per warp at once (see the source's note).

Gradients: both tiers are linear, so the backward is the exact kernel over
the transposed (src-sorted) CSR, as `_spmm_bwd` (:265-270) reuses the
kernel on the transposed plan; the int8 tier's backward is straight-through
on the exact kernel (:421-425).

Every reduction has a plain PyTorch version here (`plain_csr_sum_bf16`,
`plain_csr_sum_int8`) with the same rounding and quantisation. A wrapper
takes it only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. `counts` records kernel launches per instantiation;
plain-version calls on CUDA tensors go to `cuda_build.counts`.

The kernel is built with nvcc for sm_90a into `build/glnn_tpu_torch/` at
first use and loaded with ctypes (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes

import torch

from glnn_tpu_torch.ops import cuda_build
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids

KERNELS = ("spmm_csr_bf16", "spmm_csr_int8")
counts = {name: 0 for name in KERNELS}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"spmm_csr_bf16": [_vp, _vp, _vp, _vp, _ci, _ci, _vp],
               "spmm_csr_int8": [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _vp]}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _check(indptr, indices, x, n_rows, dtype):
    if x.dtype != dtype or x.dim() != 2:
        raise TypeError(f"expected a 2-D {dtype} tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    for name, t in (("indptr", indptr), ("indices", indices)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if indptr.numel() < n_rows + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries for "
                         f"{n_rows} rows")


def _launch(name, indptr, indices, x, scale, n_rows):
    x = x.contiguous()
    out = torch.empty((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    lib = cuda_build.load("spmm", _SIGNATURES)
    ptrs = [indptr.data_ptr(), indices.data_ptr(), x.data_ptr()]
    if scale is not None:
        ptrs.append(scale.data_ptr())
    cuda_build.launch(name, getattr(lib, name), x.device, *ptrs,
                      out.data_ptr(), n_rows, x.shape[1])
    counts[name] += 1
    return out


def plain_csr_sum_bf16(indptr, indices, xb, n_rows):
    """Plain version of the exact kernel: f32 sums of bf16 rows."""
    note_plain(xb)
    msgs = xb.index_select(0, indices[: int(indptr[n_rows])]).float()
    out = torch.zeros((n_rows, xb.shape[1]), dtype=torch.float32,
                      device=xb.device)
    return out.index_add_(0, row_ids(indptr, n_rows), msgs)


def plain_csr_sum_int8(indptr, indices, q, scale, n_rows):
    """Plain version of the int8 kernel: exact int32 sums of int8 rows,
    then the per-column dequantisation."""
    note_plain(q)
    msgs = q.index_select(0, indices[: int(indptr[n_rows])]).int()
    acc = torch.zeros((n_rows, q.shape[1]), dtype=torch.int32,
                      device=q.device)
    acc.index_add_(0, row_ids(indptr, n_rows), msgs)
    return acc.float() * scale[None, :]


def csr_sum_bf16(indptr, indices, xb, n_rows):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} xb[indices[e]] in f32.
    `indices` must lie in [0, xb.shape[0]) (build_graph guarantees it)."""
    _check(indptr, indices, xb, n_rows, torch.bfloat16)
    if xb.is_cuda:
        return _launch("spmm_csr_bf16", indptr, indices, xb, None, n_rows)
    return plain_csr_sum_bf16(indptr, indices, xb, n_rows)


def csr_sum_int8(indptr, indices, q, scale, n_rows):
    """Dequantised int32 sums of int8 rows: acc[v, f] * scale[f]."""
    _check(indptr, indices, q, n_rows, torch.int8)
    if scale.dtype != torch.float32 or scale.shape != (q.shape[1],):
        raise TypeError("scale must be f32 [F]")
    if q.is_cuda:
        return _launch("spmm_csr_int8", indptr, indices, q,
                       scale.contiguous(), n_rows)
    return plain_csr_sum_int8(indptr, indices, q, scale, n_rows)


def to_message(x: torch.Tensor) -> torch.Tensor:
    """The exact tier's message dtype: f32 is cast to bf16 once, before the
    gather; bf16 passes through."""
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"copy_u_sum takes f32 or bf16 features, got {x.dtype}")
    return x


def quantize_cols(x: torch.Tensor):
    """Per-column int8 quantisation (spmm_pallas.py:401-405): scale =
    absmax / 127 (1 where a column is all zero), q = round(x / scale)."""
    s = x.float().abs().amax(dim=0) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x.float() / s[None, :]), -127, 127)
    return q.to(torch.int8), s


class _CopyUSum(torch.autograd.Function):
    """H = A x with A the dst-sorted CSC; dX = A^T dH on the exact tier."""

    @staticmethod
    def forward(ctx, x, g, tier):
        ctx.g = g
        if tier == "int8":
            q, s = quantize_cols(x)
            out = csr_sum_int8(g.indptr, g.senders, q, s, g.n_nodes)
        else:
            out = csr_sum_bf16(g.indptr, g.senders, to_message(x.contiguous()),
                               g.n_nodes)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dh):
        g = ctx.g
        dx = csr_sum_bf16(g.t_indptr, g.t_receivers,
                          to_message(dh.contiguous()), g.n_nodes)
        return dx.to(dh.dtype), None, None


def copy_u_sum(g, x: torch.Tensor) -> torch.Tensor:
    """Exact tier: H[v] = sum over in-neighbours of bf16(x), f32 sums."""
    return _CopyUSum.apply(x, g, "bf16")


def copy_u_sum_int8(g, x: torch.Tensor) -> torch.Tensor:
    """int8 tier: per-column int8 messages, exact int32 sums, dequantised."""
    return _CopyUSum.apply(x, g, "int8")
