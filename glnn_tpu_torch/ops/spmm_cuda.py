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
f32 torch, which JAX also leaves outside its kernel. With one weight per
edge the walk gathers only the edges whose weight is not 0 (APPNP's edge
drop zeroes half of them): each 32-edge window is compacted to its kept
edges before any row is read, so dense weights walk as before and a
dropped edge's row is never read (csrc/spmm_csr.cu has the note). While a
profiler runs, each walk adds its gathered edges per work item to a
counter on the device; `gather_counts` reads the totals.

APPNP's hop (nn/layers.py appnp_propagate), h' = (1 - alpha) D_in^-1/2
A_w D_out^-1/2 h + alpha h0, runs inside these walks where its dispatch
(`ops.appnp_hop`) allows: `appnp_hop` (an autograd Function) for a
training hop with edge-drop weights, one fused weighted walk forward and
one fused transposed walk for dX in the backward (dh0 = alpha dH is one
torch multiply), and `appnp_hop_int8` for an eval hop on the int8 tier
(the rows h * src_norm quantised as `copy_u_sum_int8` quantises them, then
one fused int8 walk). The walks take the degree norms kept on the Graph
(`refops.degree_norms`) and round every step as the composition's torch
ops do (csrc/spmm_csr.cu has the formulas), so each hop is bit-equal to
`gcn_norm_both` followed by the teleport. Their launches count under
`spmm_csr_weighted` and `spmm_csr_int8`, and each walk runs in the span of
its sum.

The f32 sum behind `feature_prop` (--feature_aug_k), `spmm_csr_f32`:
H[v] = sum over in-edges e of x[src(e)], f32 rows summed in f32, has a body
of its own (`csrc/spmm_f32.cu`). It has no TPU kernel: JAX takes an f32 XLA
segment sum there (`glnn_tpu/ops/refops.py:37 copy_u_sum` under
`glnn_tpu/ops/graph_utils.py:22`), and rounding the messages to bf16 would
compound over the hops. Each warp keeps several source rows in flight
through a ring of shared-memory stages filled by cp.async; `f32_geometry`
works out its layout. A row of more than F32_CHUNK edges is split across
warps as below. Its plain version is `refops.csr_sum_f32`.

Hub rows (every kernel here, and the GAT kernels): a row of more than T
edges is cut into chunks of T edges (HUB_CHUNK for the template body and
the segment softmax, `gat_cuda.GAT_CHUNK` for the GAT layer's gat_fwd
and gat_bwd, F32_CHUNK for the f32 sum), one warp each, whose partials a
second kernel sums in chunk order, so no warp walks a hub row alone and
two launches are bit-equal; a row of at most T edges takes one warp.
`hub_plan` lists the chunks of a CSR (two host synchronisations), and
`plan_of` keeps it on the object that owns the CSR (`Graph.cache` for
`indptr` and `t_indptr`, a halo shard's `cache` for its CSRs;
`WeightedCSR` carries its two), so a plan is built once per CSR and T
and every call can be captured in a CUDA graph; `builds` counts the
plans built. Each entry point takes the
plan (built at the call when None); a call on a CSR with such rows
launches both kernels, two launches in `counts`.

Every reduction has a plain PyTorch version (`plain_csr_sum_bf16`,
`plain_csr_sum_int8`, `plain_csr_wsum_bf16` here, `refops.csr_sum_f32`) with
the same rounding and quantisation. A wrapper
takes it only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. `counts` records kernel launches per instantiation;
plain-version calls on CUDA tensors go to `cuda_build.counts`. Each entry
point's call runs in a span `kernel.<name>` of `counts`, and each plan
build in `plan.hub_plan` (recorded only under a profiler,
utils/profiling.py).

The kernels are built with nvcc for sm_90a into `build/glnn_tpu_torch/` at
first use and loaded with ctypes (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from glnn_tpu_torch.ops import cuda_build, refops
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids
from glnn_tpu_torch.utils.profiling import recording, span

KERNELS = ("spmm_csr_bf16", "spmm_csr_int8", "spmm_csr_weighted",
           "spmm_csr_f32")
counts = {name: 0 for name in KERNELS}
# hub plans built (`hub_plan`): one per CSR and T on a path whose plans are
# kept, however many calls walk it
builds = {"hub_plan": 0}

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"spmm_csr_bf16": [_vp] * 6 + [_ci] * 7 + [_vp],
               "spmm_csr_int8": [_vp] * 7 + [_ci] * 7 + [_vp],
               "spmm_csr_weighted": [_vp] * 9 + [_ci] * 8 + [_vp],
               "spmm_csr_weighted_hop":
                   [_vp] * 12 + [_ci] * 5 + [_cf] * 2 + [_ci] * 3 + [_vp],
               "spmm_csr_int8_hop":
                   [_vp] * 9 + [_ci] * 4 + [_cf] * 2 + [_ci] * 3 + [_vp],
               "spmm_csr_bf16_combine": [_vp] * 4 + [_ci] * 2 + [_vp],
               "spmm_csr_int8_combine": [_vp] * 5 + [_ci] * 2 + [_vp],
               "spmm_csr_weighted_combine": [_vp] * 4 + [_ci] * 2 + [_vp],
               "spmm_csr_weighted_hop_combine":
                   [_vp] * 6 + [_ci] * 3 + [_cf] * 2 + [_vp],
               "spmm_csr_int8_hop_combine":
                   [_vp] * 7 + [_ci] * 2 + [_cf] * 2 + [_vp]}
_F32_SIGNATURES = {"spmm_csr_f32": [_vp] * 6 + [_ci] * 8 + [_vp],
                   "spmm_csr_f32_combine": [_vp] * 4 + [_ci] * 2 + [_vp]}
# T of the template body (csrc/spmm_csr.cu) and of the segment softmax:
# rows of more edges are split into chunks of T edges, one warp each, whose
# partials a second kernel sums in chunk order. 512 measured best for the
# template on the hub graph, and is the f32 sum's T as well, so one plan
# per CSR serves all of them (csrc/spmm_csr.cu has the sweep's numbers);
# the GAT layer keeps its own (gat_cuda.GAT_CHUNK)
HUB_CHUNK = 512
# csrc/spmm_f32.cu's kChunkEdges (T); the kernel refuses a plan cut with
# another T
F32_CHUNK = 512
# copies per lane per stage: a stage holds the slices of
# 32 * F32_COPIES // Q edges (Q the pieces of a slice, at most 32)
F32_COPIES = 4


# the weighted walks' gathers, counted only while a profiler runs (as the
# spans record): the edges of the CSRs walked, and per device an int32 count
# per work item of the edges gathered, which every counted walk adds to
_walked = [0]
_gathered: dict = {}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0
    builds["hub_plan"] = 0
    _walked[0] = 0
    _gathered.clear()


def gather_counts() -> dict:
    """{"walked": the edges of the CSRs the weighted walks walked,
    "gathered": the edges they gathered (the kept ones: a weight of 0 is
    skipped)} since `reset_counts`, counted only while a profiler runs.
    The per-item counts are summed on the device here: one host
    synchronisation per device, when read."""
    return {"walked": _walked[0],
            "gathered": sum(int(b.sum()) for b in _gathered.values())}


def _gather_counter(device, items: int, walked: int):
    """The device's per-item count of gathered edges, at least `items`
    long, with `walked` edges counted; None while no profiler runs."""
    if not recording():
        return None
    buf = _gathered.get(device)
    if buf is None or buf.numel() < items:
        grown = torch.zeros(items, dtype=torch.int32, device=device)
        if buf is not None:
            grown[:buf.numel()] = buf
        _gathered[device] = buf = grown
    _walked[0] += walked
    return buf


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


class HubPlan(NamedTuple):
    """The hub rows of a CSR cut into chunks of T edges, the work list of
    every kernel that splits rows across warps: `rows` int32 [S], each row
    of more than T edges in row order; `first` int32 [S + 1], row s's
    chunks are first[s]:first[s + 1]; `chunks` int32 [C, 2], each chunk's
    edge range [start, end), T edges but a row's last; `owner` int32 [C],
    each chunk's split row s; `n_chunks` = C; `chunk` = T; `n_rows`, the
    CSR's rows."""
    rows: torch.Tensor
    first: torch.Tensor
    chunks: torch.Tensor
    owner: torch.Tensor
    n_chunks: int
    chunk: int
    n_rows: int


@span("plan.hub_plan")
def hub_plan(indptr: torch.Tensor, n_rows: int,
             chunk: int = HUB_CHUNK) -> HubPlan:
    """The hub plan of the CSR `indptr` of n_rows rows with T = `chunk`, on
    indptr's device. Two host synchronisations, so a plan is built once per
    CSR and kept (`plan_of`), never inside a hot call; counted in
    `builds`."""
    dev, t = indptr.device, int(chunk)
    if t < 1:
        raise ValueError(f"a hub plan cuts rows into chunks of T >= 1 edges, "
                         f"got {t}")
    builds["hub_plan"] += 1
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
    return HubPlan(rows.int(), first.int(), chunks.int().contiguous(),
                   owner.int(), n_chunks, t, n_rows)


def plan_of(owner, name: str, n_rows: int,
            chunk: int = HUB_CHUNK) -> HubPlan:
    """The hub plan of the CSR `getattr(owner, name)` (a row pointer of n_rows
    rows), built at the first call and kept in `owner.cache` (a Graph or a
    halo shard; a moved or replaced one builds its own). On the CPU, where
    the plain versions need none, it is kept all the same."""
    key = ("hub_plan", name, n_rows, int(chunk))
    if key not in owner.cache:
        owner.cache[key] = hub_plan(getattr(owner, name), n_rows, chunk)
    return owner.cache[key]


def graph_f32_plan(g) -> HubPlan:
    """The f32 kernel's plan of g's dst-sorted CSR (T = F32_CHUNK), kept on
    g."""
    return plan_of(g, "indptr", g.n_nodes, F32_CHUNK)


def check_plan(plan: HubPlan, n_rows: int, device, chunk=None) -> None:
    if plan.n_rows != n_rows or plan.chunks.device != device or (
            chunk is not None and plan.chunk != chunk):
        raise ValueError(f"the plan was cut for {plan.n_rows} rows with T = "
                         f"{plan.chunk} on {plan.chunks.device}; this call "
                         f"walks {n_rows} rows on {device}"
                         + ("" if chunk is None else f" with T = {chunk}"))


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


def _launch(name, indptr, ptrs, x, n_rows, plan, geo, extra=(),
            combine_ptrs=(), combine_extra=(), entry=None, walked=None):
    """The walk `entry` (`name` by default; indptr, the pointers `ptrs`,
    then out, the plan's chunks and partials, the rows, chunks, T and f,
    `extra`, the geometry) and, where the plan has chunks, `entry`_combine,
    the sum of the split rows' partials (the plan's rows, first and
    partials, `combine_ptrs`, out, the split rows and f, `combine_extra`);
    each launch counted under `name`. `plan` is indptr's hub plan (built
    here when None: two host synchronisations). A weighted walk of
    `walked` edges takes its gather counter (`_gather_counter`, or null)
    as its last pointer before out."""
    if plan is None:
        plan = hub_plan(indptr, n_rows)
    check_plan(plan, n_rows, x.device)
    entry = entry or name
    f, c = x.shape[1], plan.n_chunks
    if walked is not None:
        counter = _gather_counter(x.device, c + n_rows, walked)
        ptrs = [*ptrs, None if counter is None else counter.data_ptr()]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    part = None
    if c:   # the chunks' partials: int32 sums for the int8 policy
        part = torch.empty((c, f), device=x.device, dtype=torch.int32
                           if name == "spmm_csr_int8" else torch.float32)
    lib = cuda_build.load("spmm", _SIGNATURES)
    cuda_build.launch(
        name, getattr(lib, entry), x.device, indptr.data_ptr(), *ptrs,
        out.data_ptr(),
        plan.chunks.data_ptr() if c else None, part.data_ptr() if c else None,
        n_rows, c, plan.chunk, f, *extra, *geo)
    counts[name] += 1
    if c:
        cuda_build.launch(
            name, getattr(lib, f"{entry}_combine"), x.device,
            plan.rows.data_ptr(), plan.first.data_ptr(), part.data_ptr(),
            *combine_ptrs, out.data_ptr(), plan.rows.numel(), f,
            *combine_extra)
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


@span("kernel.spmm_csr_bf16")
def csr_sum_bf16(indptr, indices, xb, n_rows, plan: HubPlan | None = None):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} xb[indices[e]] in f32.
    `indices` must lie in [0, xb.shape[0]) (build_graph guarantees it).
    `plan` is the CSR's hub plan (`plan_of`; built here when None)."""
    _check(indptr, indices, xb, n_rows, torch.bfloat16)
    if xb.is_cuda:
        xb = xb.contiguous()
        return _launch("spmm_csr_bf16", indptr,
                       [indices.data_ptr(), xb.data_ptr()], xb, n_rows, plan,
                       geometry(xb.shape[1], 2, align=xb.data_ptr()))
    return plain_csr_sum_bf16(indptr, indices, xb, n_rows)


@span("kernel.spmm_csr_f32")
def csr_sum_f32(indptr, indices, x, n_rows, plan: HubPlan | None = None):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} x[indices[e]], f32 rows
    summed in f32; on a CPU tensor its plain version, refops.csr_sum_f32.
    `plan` is the CSR's hub plan with T = F32_CHUNK (made here when
    None)."""
    _check(indptr, indices, x, n_rows, torch.float32)
    if not x.is_cuda:
        return refops.csr_sum_f32(indptr, indices, x, n_rows)
    if plan is None:
        plan = hub_plan(indptr, n_rows, F32_CHUNK)
    check_plan(plan, n_rows, x.device, F32_CHUNK)
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


@span("kernel.spmm_csr_int8")
def csr_sum_int8(indptr, indices, q, scale, n_rows,
                 plan: HubPlan | None = None):
    """Dequantised int32 sums of int8 rows: acc[v, f] * scale[f]; `plan`
    as csr_sum_bf16 takes it."""
    _check(indptr, indices, q, n_rows, torch.int8)
    if scale.dtype != torch.float32 or scale.shape != (q.shape[1],):
        raise TypeError("scale must be f32 [F]")
    if q.is_cuda:
        q, scale = q.contiguous(), scale.contiguous()
        return _launch("spmm_csr_int8", indptr,
                       [indices.data_ptr(), q.data_ptr(), scale.data_ptr()],
                       q, n_rows, plan,
                       geometry(q.shape[1], 1, align=q.data_ptr()),
                       combine_ptrs=[scale.data_ptr()])
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


@span("kernel.spmm_csr_weighted")
def csr_wsum_bf16(indptr, indices, widx, x, w, n_rows,
                  plan: HubPlan | None = None):
    """out[v] = sum_{e in indptr[v]:indptr[v+1]} bf16(x[indices[e]] *
    w[widx(e)]) in f32: x f32 [*, F], w f32 [E] or [E, H] (H dividing F;
    column c takes head c / (F / H)), widx int32 or None (the slot itself);
    `plan` as csr_sum_bf16 takes it."""
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
        f = x.shape[1]
        return _launch("spmm_csr_weighted", indptr,
                       [indices.data_ptr(),
                        None if widx is None else widx.data_ptr(),
                        x.data_ptr(), w.data_ptr()],
                       x, n_rows, plan,
                       geometry(f, 4, f // heads, align=x.data_ptr()),
                       extra=[heads], walked=indices.numel())
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
    """H = A x with A the dst-sorted CSC; dX = A^T dH on the exact tier.
    The hub plans of both walks are kept on the Graph."""

    @staticmethod
    def forward(ctx, x, g, tier):
        ctx.g = g
        plan = plan_of(g, "indptr", g.n_nodes)
        if tier == "int8":
            q, s = quantize_cols(x)
            out = csr_sum_int8(g.indptr, g.senders, q, s, g.n_nodes, plan)
        else:
            out = csr_sum_bf16(g.indptr, g.senders, to_message(x.contiguous()),
                               g.n_nodes, plan)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dh):
        g = ctx.g
        dx = csr_sum_bf16(g.t_indptr, g.t_receivers,
                          to_message(dh.contiguous()), g.n_nodes,
                          plan_of(g, "t_indptr", g.n_nodes))
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
    slot's dst row; t_edges, its edge); `plan` and `t_plan`, the hub plans
    of the two walks (`plan_of` on the owner of the CSR; None builds them
    at each call on CUDA)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    dst: torch.Tensor
    t_indptr: torch.Tensor
    t_dst: torch.Tensor
    t_edges: torch.Tensor
    n_rows: int
    n_src: int
    plan: HubPlan | None = None
    t_plan: HubPlan | None = None


class _UMulESum(torch.autograd.Function):
    """H = A_w x with A a dst-sorted CSR; dX = A_w^T dH on the kernel,
    dW = <x[src], dH[dst]> in plain f32 torch when asked for."""

    @staticmethod
    def forward(ctx, x, w, csr):
        ctx.csr = csr
        ctx.save_for_backward(x, w)
        out = csr_wsum_bf16(csr.indptr, csr.indices, None,
                            x.reshape(x.shape[0], -1).float(), w.float(),
                            csr.n_rows, csr.plan)
        return out.view((csr.n_rows,) + tuple(x.shape[1:])).to(x.dtype)

    @staticmethod
    def backward(ctx, dh):
        x, w = ctx.saved_tensors
        csr = ctx.csr
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = csr_wsum_bf16(csr.t_indptr, csr.t_dst, csr.t_edges,
                               dh.reshape(csr.n_rows, -1).float(), w.float(),
                               csr.n_src, csr.t_plan)
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
    return _UMulESum.apply(x, w, weighted_csr(g))


def weighted_csr(g) -> WeightedCSR:
    """The Graph g as the weighted sum walks it, with its kept plans."""
    return WeightedCSR(
        g.indptr, g.senders, g.receivers, g.t_indptr, g.t_receivers,
        g.t_edges, g.n_nodes, g.n_nodes, plan_of(g, "indptr", g.n_nodes),
        plan_of(g, "t_indptr", g.n_nodes))


# ---- APPNP's hop inside the walks ------------------------------------------


def _row_aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, copied where its base is not 16-byte aligned (the
    hop's walks read h0 as they write rows, 16 bytes a lane)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_hop(g, h, h0, *norms):
    if h0 is not None and (h0.dtype != torch.float32
                           or h0.shape != (g.n_nodes, h.shape[1])
                           or h0.device != h.device):
        raise TypeError(f"h0 must be f32 [{g.n_nodes}, {h.shape[1]}] on "
                        f"{h.device}")
    for norm in norms:
        if (norm.dtype != torch.float32 or norm.shape != (g.n_nodes,)
                or norm.device != h.device):
            raise TypeError(f"the degree norms must be f32 [{g.n_nodes}] "
                            f"on {h.device}")


def _teleport(out, dst_norm, h0, alpha):
    """The composition's epilogue: (out * d) * (1 - alpha) + alpha * h0."""
    return (out * dst_norm[:, None]) * (1.0 - alpha) + alpha * h0


def plain_appnp_wsum(g, x, w, gather_norm, row_norm, h0, alpha, transposed):
    """Plain version of the fused weighted hop walks, the composition they
    replace, op for op: forward ((A_w (x * s)) * d) * (1 - alpha) + alpha
    * h0, with A_w the weighted sum (`plain_csr_wsum_bf16`); transposed
    (A_w^T ((x * (1 - alpha)) * d)) * s."""
    if transposed:
        xs = (x * (1.0 - alpha)) * gather_norm[:, None]
        out = plain_csr_wsum_bf16(g.t_indptr, g.t_receivers, g.t_edges, xs,
                                  w, g.n_nodes)
        return out * row_norm[:, None]
    out = plain_csr_wsum_bf16(g.indptr, g.senders, None,
                              x * gather_norm[:, None], w, g.n_nodes)
    return _teleport(out, row_norm, h0, alpha)


@span("kernel.spmm_csr_weighted")
def appnp_wsum(g, x, w, gather_norm, row_norm, h0, alpha: float,
               transposed: bool):
    """One walk of APPNP's training hop over the Graph g with edge weights
    w f32 [E] (dst-sorted order): the forward over the CSC (gather_norm
    the source norm, row_norm the destination norm, h0 the teleport's
    rows), or, `transposed`, the backward's dX over the transposed CSR
    (gather_norm the destination norm, row_norm the source norm, h0
    None). x f32 [N, F]; the plans kept on g."""
    n = g.n_nodes
    if transposed:
        indptr, indices, widx = g.t_indptr, g.t_receivers, g.t_edges
    else:
        indptr, indices, widx = g.indptr, g.senders, None
    _check(indptr, indices, x, n, torch.float32)
    _check_hop(g, x, h0, gather_norm, row_norm)
    if w.dtype != torch.float32 or w.shape != (g.n_edges,):
        raise TypeError(f"w must be f32 [{g.n_edges}]")
    if not x.is_cuda:
        return plain_appnp_wsum(g, x, w, gather_norm, row_norm, h0, alpha,
                                transposed)
    x, w = x.contiguous(), w.contiguous()
    h0 = None if h0 is None else _row_aligned(h0)
    f = x.shape[1]
    hop = [int(transposed), 1.0 - alpha, alpha]
    h0_ptr = None if h0 is None else h0.data_ptr()
    return _launch(
        "spmm_csr_weighted", indptr,
        [indices.data_ptr(), None if widx is None else widx.data_ptr(),
         x.data_ptr(), w.data_ptr(), gather_norm.data_ptr(),
         row_norm.data_ptr(), h0_ptr],
        x, n, plan_of(g, "t_indptr" if transposed else "indptr", n),
        geometry(f, 4, f, align=x.data_ptr()), extra=hop,
        combine_ptrs=[row_norm.data_ptr(), h0_ptr], combine_extra=hop,
        entry="spmm_csr_weighted_hop", walked=g.n_edges)


class _AppnpHop(torch.autograd.Function):
    """h' = (1 - alpha) D_in^-1/2 A_w D_out^-1/2 h + alpha h0 on the fused
    weighted walk; dh = the fused transposed walk of dh', dh0 = alpha dh'.
    w (edge-drop weights) takes no gradient, so it is all that is
    saved. h0 comes first: where h is h0 (the first hop), autograd then
    adds dh0 to h0's gradient before dh, as it does through the
    composition's teleport, so the whole gradient keeps its bits."""

    @staticmethod
    def forward(ctx, h0, h, w, g, alpha):
        ctx.g, ctx.alpha = g, alpha
        ctx.save_for_backward(w)
        src_norm, dst_norm = refops.degree_norms(g)
        return appnp_wsum(g, h, w, src_norm, dst_norm, h0, alpha, False)

    @staticmethod
    def backward(ctx, dout):
        w, = ctx.saved_tensors
        g, alpha = ctx.g, ctx.alpha
        src_norm, dst_norm = refops.degree_norms(g)
        dh0 = dh = None
        if ctx.needs_input_grad[0]:
            dh0 = dout * alpha
        if ctx.needs_input_grad[1]:
            dh = appnp_wsum(g, dout.contiguous(), w, dst_norm, src_norm, None,
                            alpha, True)
        return dh0, dh, None, None, None


def appnp_hop(g, h: torch.Tensor, h0: torch.Tensor, w: torch.Tensor,
              alpha: float) -> torch.Tensor:
    """APPNP's training hop with edge-drop weights w f32 [E] on the fused
    weighted walks: h, h0 f32 [N, F] on a Graph g; differentiable in h and
    h0."""
    return _AppnpHop.apply(h0, h, w, g, alpha)


def plain_appnp_sum_int8(g, q, scale, row_norm, h0, alpha):
    """Plain version of the fused int8 hop walk: ((the int8 sum) * d) *
    (1 - alpha) + alpha * h0."""
    return _teleport(plain_csr_sum_int8(g.indptr, g.senders, q, scale,
                                        g.n_nodes), row_norm, h0, alpha)


@span("kernel.spmm_csr_int8")
def appnp_sum_int8(g, q, scale, row_norm, h0, alpha: float):
    """The fused int8 walk of APPNP's eval hop: q int8 [N, F] and its f32
    scale [F] (`quantize_cols` of h * src_norm), row_norm the destination
    norm, h0 f32 [N, F]."""
    n = g.n_nodes
    _check(g.indptr, g.senders, q, n, torch.int8)
    _check_hop(g, q, h0, row_norm)
    if scale.dtype != torch.float32 or scale.shape != (q.shape[1],):
        raise TypeError("scale must be f32 [F]")
    if not q.is_cuda:
        return plain_appnp_sum_int8(g, q, scale, row_norm, h0, alpha)
    q, scale, h0 = q.contiguous(), scale.contiguous(), _row_aligned(h0)
    hop = [1.0 - alpha, alpha]
    return _launch(
        "spmm_csr_int8", g.indptr,
        [g.senders.data_ptr(), q.data_ptr(), scale.data_ptr(),
         row_norm.data_ptr(), h0.data_ptr()],
        q, n, plan_of(g, "indptr", n),
        geometry(q.shape[1], 1, align=q.data_ptr()), extra=hop,
        combine_ptrs=[scale.data_ptr(), row_norm.data_ptr(), h0.data_ptr()],
        combine_extra=hop, entry="spmm_csr_int8_hop")


def appnp_hop_int8(g, h: torch.Tensor, h0: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """APPNP's eval hop on the int8 tier, no gradient: h * src_norm
    quantised per column as `copy_u_sum_int8` quantises it, then the
    fused int8 walk."""
    src_norm, dst_norm = refops.degree_norms(g)
    q, s = quantize_cols(h * src_norm[:, None])
    return appnp_sum_int8(g, q, s, dst_norm, h0, alpha)
