"""CSR SpMM on the GPU: the hand-written CUDA kernel behind `copy_u_sum`.

Replaces the TPU kernels `glnn_tpu/ops/spmm_pallas.py:_block_kernel` (:93,
block mode) and `:_kernel` (:59, tiled mode): one segmented sum
H[v] = sum over in-edges e of v of x[src(e)], in two tiers.

* exact: x is cast to bf16 before the kernel (as spmm_pallas.py:244-250
  casts before its gather), the kernel sums the bf16 rows in f32, and the
  result is cast back to x's dtype (:258).
* int8: x is quantised per column (absmax / 127, round half to even, in
  x's dtype; plain torch, since the quantisation lies outside the Pallas
  kernel too, :401-405), the kernel sums int8 rows in int32 (exact) and
  multiplies each column by its f32 scale (:408-414).

Under the bf16 compute tier x arrives in bf16: the exact tier gathers it
as it is, and both tiers cast their f32 sums back to bf16; the backward
walks the transposed CSR with the bf16 cotangent.

The kernel (`csrc/spmm_csr.cu`) walks the dst-sorted CSC directly: a warp
owns a dst row and sums the gathered rows in registers, so there is no
one-hot, no message tensor and no atomics. It is bound by bytes on an H100
(the E * F * itemsize bytes of gathered rows, the indices, and the N * F * 4
bytes of output). Its lanes lie across (edge, column group) pairs, so that
several row reads of up to 16 bytes per lane are in flight and a row takes
one pass over its edges; `geometry` works out that layout (see the
source's note) and every launch passes it to the kernel, which checks it.

Gradients: both tiers are linear, so the backward is the exact kernel over
the transposed (src-sorted) CSR, as `_spmm_bwd` (:265-270) reuses the
kernel on the transposed plan; the int8 tier's backward is straight-through
on the exact kernel (:421-425).

The weighted sum behind `u_mul_e_sum` (spmm_pallas.py:438, messages at
:288-310) is a third instantiation, `spmm_csr_weighted`:
H[v] = sum over in-edges e of bf16(x[src(e)] * w[e]) in f32, with one
scalar per edge (x [N, F], w [E]) or one per edge and head (x [N, H, D],
w [E, H]). The kernel multiplies f32 rows by the weight and rounds each
product once to bf16, as JAX rounds the weighted message. Its backward
(:329-353) is the same kernel over the transposed CSR, reading the weights
through `t_edges`, for dX; and, only when the weights need a gradient, the
SDDMM dW[e] = <x[src(e)], dH[dst(e)]> (per head: summed over D) in plain
f32 torch, which JAX also leaves outside its kernel.

The f32 sum behind `feature_prop` (--feature_aug_k), `spmm_csr_f32`:
H[v] = sum over in-edges e of x[src(e)], f32 rows summed in f32, has a body
of its own (`csrc/spmm_f32.cu`). It has no TPU kernel: JAX takes an f32 XLA
segment sum there (`glnn_tpu/ops/refops.py:37 copy_u_sum` under
`glnn_tpu/ops/graph_utils.py:22`), and rounding the messages to bf16 would
compound over the hops. Each warp keeps several source rows in flight
through a ring of shared-memory stages filled by cp.async; `f32_geometry`
works out its layout. A row of more than F32_CHUNK edges is cut into
chunks of F32_CHUNK edges, one warp each, whose f32 partials a second
kernel sums in chunk order, so two launches are bit-equal; `f32_plan` lists
the chunks (built once per graph and cached on it, `graph_f32_plan`), and
a call on a graph with such rows launches both kernels (two launches in
`counts`). Its plain version is `refops.csr_sum_f32`.

Every reduction has a plain PyTorch version (`plain_csr_sum_bf16`,
`plain_csr_sum_int8`, `plain_csr_wsum_bf16` here, `refops.csr_sum_f32`) with
the same rounding and quantisation. A wrapper
takes it only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. `counts` records kernel launches per instantiation;
plain-version calls on CUDA tensors go to `cuda_build.counts`.

The kernels are built with nvcc for sm_90a into `build/glnn_tpu_torch/` at
first use and loaded with ctypes (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from glnn_tpu_torch.ops import cuda_build, refops
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids

KERNELS = ("spmm_csr_bf16", "spmm_csr_int8", "spmm_csr_weighted",
           "spmm_csr_f32")
counts = {name: 0 for name in KERNELS}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"spmm_csr_bf16": [_vp] * 4 + [_ci] * 5 + [_vp],
               "spmm_csr_int8": [_vp] * 5 + [_ci] * 5 + [_vp],
               "spmm_csr_weighted": [_vp] * 6 + [_ci] * 6 + [_vp]}
_F32_SIGNATURES = {"spmm_csr_f32": [_vp] * 6 + [_ci] * 8 + [_vp],
                   "spmm_csr_f32_combine": [_vp] * 4 + [_ci] * 2 + [_vp]}
# csrc/spmm_f32.cu's kChunkEdges (T): rows of more edges are split into
# chunks of T edges; the kernel refuses a plan cut with another T
F32_CHUNK = 512
# copies per lane per stage: a stage holds the slices of
# 32 * F32_COPIES // Q edges (Q the pieces of a slice, at most 32)
F32_COPIES = 4


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def geometry(f: int, itemsize: int, head_width: int | None = None,
             align: int = 16) -> tuple[int, int, int]:
    """(vec, lanes, groups): the kernel's lane layout for rows of f elements
    of `itemsize` bytes. vec is the widest load of at most 16 bytes and 8
    elements that divides f (and the weighted policy's head width) and
    keeps every row aligned, given base addresses aligned to `align` bytes;
    `lanes` = ceil(f / vec), at most 32, cover a row's columns, and groups
    = 32 // lanes edge groups take every groups-th edge of the row, so a
    row up to 32 * vec wide takes one pass over its edges. (16 int8
    elements per lane measured slower on an H100 at every width: twice
    the accumulators, and twice the shuffles where the groups' sums
    merge; tools/sweep_cuda_kernels.py.)"""
    vec = min(8, 16 // itemsize)
    while vec > 1 and (f % vec or (head_width is not None and head_width % vec)
                       or align % (vec * itemsize)):
        vec //= 2
    lanes = min(32, -(-f // vec))
    return vec, lanes, 32 // lanes


class F32Geometry(NamedTuple):
    """spmm_csr_f32's layout: vec floats per copy (16, 8 or 4 bytes), a
    warp's column chunk of `width` columns (Q = width // vec pieces, at
    most 32), `groups` = 32 // Q edge groups in the sum, and `stage_edges`
    edges per stage."""
    vec: int
    width: int
    groups: int
    stage_edges: int


def f32_geometry(f: int, align: int = 16) -> F32Geometry:
    """The f32 kernel's layout for rows of f floats whose base is aligned
    to `align` bytes: vec the widest copy of at most 4 floats that divides
    f and keeps every row aligned; the f // vec pieces cut into
    ceil(pieces / 32) column chunks of equal width but the last; G =
    32 * F32_COPIES // Q edges a stage (at most 32), so that the stage's
    G * Q copies fill the lanes' copy steps (F = 128: 4 x 32; F = 100:
    5 x 25 of 128)."""
    vec = 4
    while vec > 1 and (f % vec or align % (vec * 4)):
        vec //= 2
    pieces = f // vec
    chunks = -(-pieces // 32)
    q = -(-pieces // chunks)
    return F32Geometry(vec, q * vec, 32 // q, min(32, 32 * F32_COPIES // q))


class F32Plan(NamedTuple):
    """The hub rows of a CSR, cut for spmm_csr_f32: `rows` int32 [S], each
    row of more than F32_CHUNK edges in row order; `first` int32 [S + 1],
    row s's chunks are first[s]:first[s + 1]; `chunks` int32 [C, 2], each
    chunk's edge range [start, end), F32_CHUNK edges but a row's last;
    `n_chunks` = C; `chunk` the T it was cut with."""
    rows: torch.Tensor
    first: torch.Tensor
    chunks: torch.Tensor
    n_chunks: int
    chunk: int


def f32_plan(indptr: torch.Tensor, n_rows: int) -> F32Plan:
    """spmm_csr_f32's work list of the CSR `indptr` (on its device; two
    host synchronisations, so `graph_f32_plan` keeps one per graph)."""
    dev, t = indptr.device, F32_CHUNK
    lo = indptr[:n_rows].long()
    hi = indptr[1:n_rows + 1].long()
    rows = torch.nonzero(hi - lo > t).flatten()
    lo, hi = lo[rows], hi[rows]
    n_ck = (hi - lo + t - 1) // t
    first = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(n_ck, 0)
    n_chunks = int(first[-1])
    owner = torch.repeat_interleave(
        torch.arange(rows.numel(), device=dev), n_ck, output_size=n_chunks)
    start = lo[owner] + (torch.arange(n_chunks, device=dev)
                         - first[owner]) * t
    chunks = torch.stack([start, torch.minimum(start + t, hi[owner])], 1)
    return F32Plan(rows.int(), first.int(), chunks.int().contiguous(),
                   n_chunks, t)


def graph_f32_plan(g) -> F32Plan:
    """The f32 kernel's plan of g's dst-sorted CSR, built at the first call
    and kept on g (a moved or replaced Graph builds its own)."""
    key = ("spmm_csr_f32", F32_CHUNK)
    if key not in g.cache:
        g.cache[key] = f32_plan(g.indptr, g.n_nodes)
    return g.cache[key]


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
                      out.data_ptr(), n_rows, x.shape[1],
                      *geometry(x.shape[1], x.element_size(),
                                align=x.data_ptr()))
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


def csr_sum_f32(indptr, indices, x, n_rows, plan: F32Plan | None = None):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} x[indices[e]], f32 rows
    summed in f32; on a CPU tensor its plain version, refops.csr_sum_f32.
    `plan` is `f32_plan(indptr, n_rows)` (made here when None)."""
    _check(indptr, indices, x, n_rows, torch.float32)
    if not x.is_cuda:
        return refops.csr_sum_f32(indptr, indices, x, n_rows)
    if plan is None:
        plan = f32_plan(indptr, n_rows)
    if plan.chunk != F32_CHUNK or plan.chunks.device != x.device:
        raise ValueError(f"the plan was cut with T = {plan.chunk} on "
                         f"{plan.chunks.device}, the kernel takes T = "
                         f"{F32_CHUNK} on {x.device}")
    x = x.contiguous()
    f, c = x.shape[1], plan.n_chunks
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    part = torch.empty((c, f), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("spmm_f32", _F32_SIGNATURES)
    cuda_build.launch(
        "spmm_csr_f32", lib.spmm_csr_f32, x.device, indptr.data_ptr(),
        indices.data_ptr(), x.data_ptr(),
        plan.chunks.data_ptr() if c else None,
        part.data_ptr() if c else None, out.data_ptr(), n_rows, c, f,
        *f32_geometry(f, align=x.data_ptr()), F32_CHUNK)
    counts["spmm_csr_f32"] += 1
    if c:
        cuda_build.launch(
            "spmm_csr_f32", lib.spmm_csr_f32_combine, x.device,
            plan.rows.data_ptr(), plan.first.data_ptr(), part.data_ptr(),
            out.data_ptr(), plan.rows.numel(), f)
        counts["spmm_csr_f32"] += 1
    return out


def csr_sum_int8(indptr, indices, q, scale, n_rows):
    """Dequantised int32 sums of int8 rows: acc[v, f] * scale[f]."""
    _check(indptr, indices, q, n_rows, torch.int8)
    if scale.dtype != torch.float32 or scale.shape != (q.shape[1],):
        raise TypeError("scale must be f32 [F]")
    if q.is_cuda:
        return _launch("spmm_csr_int8", indptr, indices, q,
                       scale.contiguous(), n_rows)
    return plain_csr_sum_int8(indptr, indices, q, scale, n_rows)


def _heads(x, w):
    """Weights per edge of the weighted sum: 1 for w [E], H for w [E, H]."""
    heads = 1 if w.dim() == 1 else w.shape[1]
    if (w.dtype != torch.float32 or w.dim() not in (1, 2)
            or x.shape[1] % max(heads, 1)):
        raise TypeError(f"w must be f32 [E] or [E, H] with H dividing F = "
                        f"{x.shape[1]}, got {w.dtype} {tuple(w.shape)}")
    return heads


def plain_csr_wsum_bf16(indptr, indices, widx, x, w, n_rows):
    """Plain version of the weighted kernel: f32 sums of
    bf16(x[indices[e]] * w[widx(e)]), the product formed in f32;
    widx(e) = widx[e], or e where widx is None."""
    note_plain(x)
    n_e = int(indptr[n_rows])
    heads = _heads(x, w)
    eid = (torch.arange(n_e, device=x.device) if widx is None
           else widx[:n_e].long())
    wv = w.view(w.shape[0], heads).index_select(0, eid)     # [E, heads]
    msgs = x.index_select(0, indices[:n_e]).view(n_e, heads, -1) * wv[..., None]
    msgs = msgs.to(torch.bfloat16).float().view(n_e, x.shape[1])
    out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, row_ids(indptr, n_rows), msgs)


def csr_wsum_bf16(indptr, indices, widx, x, w, n_rows):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} bf16(x[indices[e]] *
    w[widx(e)]) in f32: x f32 [*, F], w f32 [E] or [E, H] (H dividing F;
    column c takes head c / (F / H)), widx int32 or None (the slot itself)."""
    _check(indptr, indices, x, n_rows, torch.float32)
    heads = _heads(x, w)
    if widx is not None and widx.dtype != torch.int32:
        raise TypeError(f"widx must be int32, got {widx.dtype}")
    for name, t in (("w", w), ("widx", widx)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}")
    if widx is not None and not widx.is_contiguous():
        raise ValueError("widx must be contiguous")
    if x.is_cuda:
        x, w = x.contiguous(), w.contiguous()
        out = torch.empty((n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        lib = cuda_build.load("spmm", _SIGNATURES)
        f = x.shape[1]
        cuda_build.launch(
            "spmm_csr_weighted", lib.spmm_csr_weighted, x.device,
            indptr.data_ptr(), indices.data_ptr(),
            None if widx is None else widx.data_ptr(), x.data_ptr(),
            w.data_ptr(), out.data_ptr(), n_rows, f, heads,
            *geometry(f, 4, f // heads, align=x.data_ptr()))
        counts["spmm_csr_weighted"] += 1
        return out
    return plain_csr_wsum_bf16(indptr, indices, widx, x, w, n_rows)


def to_message(x: torch.Tensor) -> torch.Tensor:
    """The exact tier's message dtype: f32 is cast to bf16 once, before the
    gather; bf16 passes through."""
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"copy_u_sum takes f32 or bf16 features, got {x.dtype}")
    return x


def quantize_cols(x: torch.Tensor):
    """Per-column int8 quantisation (spmm_pallas.py:401-405), in x's own
    dtype with the same order of operations: scale = absmax / 127 (1 where
    a column is all zero), q = round(x / scale) half to even; the scale is
    returned in f32. For bf16 x the scale and each quotient are rounded to
    bf16 as JAX rounds them, so q and s equal `_quantize_cols` bit for
    bit."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"copy_u_sum takes f32 or bf16 features, got {x.dtype}")
    s = x.abs().amax(dim=0) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x / s[None, :]), -127, 127)
    return q.to(torch.int8), s.float()


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


class WeightedCSR(NamedTuple):
    """What the weighted sum walks: the dst-sorted CSR (indptr; indices,
    each edge's source row; dst, its dst row) of n_rows rows over n_src
    source rows, and its transpose (t_indptr over the sources; t_dst, each
    slot's dst row; t_edges, its edge)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    dst: torch.Tensor
    t_indptr: torch.Tensor
    t_dst: torch.Tensor
    t_edges: torch.Tensor
    n_rows: int
    n_src: int


class _UMulESum(torch.autograd.Function):
    """H = A_w x with A a dst-sorted CSR; dX = A_w^T dH on the kernel,
    dW = <x[src], dH[dst]> in plain f32 torch when asked for."""

    @staticmethod
    def forward(ctx, x, w, csr):
        ctx.csr = csr
        ctx.save_for_backward(x, w)
        out = csr_wsum_bf16(csr.indptr, csr.indices, None,
                            x.reshape(x.shape[0], -1).float(), w.float(),
                            csr.n_rows)
        return out.view((csr.n_rows,) + tuple(x.shape[1:])).to(x.dtype)

    @staticmethod
    def backward(ctx, dh):
        x, w = ctx.saved_tensors
        csr = ctx.csr
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = csr_wsum_bf16(csr.t_indptr, csr.t_dst, csr.t_edges,
                               dh.reshape(csr.n_rows, -1).float(), w.float(),
                               csr.n_src)
            dx = dx.view(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xs = x.float().index_select(0, csr.indices)
            ds = dh.float().index_select(0, csr.dst)
            dw = (xs * ds).sum(-1).to(w.dtype)
        return dx, dw, None


def _check_weighted(x: torch.Tensor, w: torch.Tensor, n_src: int,
                    n_edges: int) -> None:
    if not ((x.dim() == 2 and w.dim() == 1)
            or (x.dim() == 3 and w.dim() == 2 and w.shape[1] == x.shape[1])):
        raise ValueError(f"u_mul_e_sum takes x [N, F] with w [E], or x "
                         f"[N, H, D] with w [E, H]; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.shape[0] != n_src or w.shape[0] != n_edges:
        raise ValueError(f"x must have {n_src} rows and w {n_edges}")


def csr_u_mul_e_sum(csr: WeightedCSR, x: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """u_mul_e_sum over the CSR `csr`: x [n_src, ...] source rows, w in
    its edge order; returns [n_rows, ...] (a halo shard's combined CSR)."""
    _check_weighted(x, w, csr.n_src, csr.indices.shape[0])
    return _UMulESum.apply(x, w, csr)


def u_mul_e_sum(g, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum H[v] = sum_e bf16(x[src(e)] w[e]) in f32, in x's dtype:
    x [N, F] with w [E], or x [N, H, D] with w [E, H] (per-head weights);
    differentiable in x and w. w follows the graph's dst-sorted edge
    order."""
    _check_weighted(x, w, g.n_nodes, g.n_edges)
    return _UMulESum.apply(x, w, WeightedCSR(
        g.indptr, g.senders, g.receivers, g.t_indptr, g.t_receivers,
        g.t_edges, g.n_nodes, g.n_nodes))
