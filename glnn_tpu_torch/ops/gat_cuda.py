"""Fused GAT attention on the GPU: the hand-written CUDA kernels behind
`ops.gat_attention`.

Replaces the TPU kernels `glnn_tpu/ops/gat_pallas.py:_gat_fwd_kernel` (:158)
and `:_gat_bwd_kernel` (:187). For each dst v and head h:
s = leaky_relu(el[u,h] + er[v,h]), alpha = softmax of s over v's in-edges,
dropout on alpha after the normalisation (dgl GATConv), and
out[v,h,:] = sum alpha * feat[u,h,:].

Prep outside the kernels (`prep`): feat is cast to bf16 once; er[v,h] in
f32, rounded once to bf16, as `_prep` (gat_pallas.py:409-420) computes it
outside its kernel; el[u,h] = <bf16 feat[u,h,:], bf16 attn_l[h,:]> summed
in f32, the TPU kernel's score matmul (:118) with the same rounding, but
computed here once per node in torch, where the TPU kernel computes it per
slot inside its body.

* `gat_fwd` (csrc/gat_csr.cu) walks the dst-sorted CSC, one warp per dst
  row: segment max (not the TPU's block max), denominator of the undropped
  weights, f32 accumulation of the bf16 source rows; it also writes the
  per-dst max and denominator [N, H] for the backward.
* `gat_bwd` recomputes alpha from the same inputs and the saved max and
  denominator and runs the f32 softmax VJP: der [N, H] f32, the per-edge
  message msg[e,h,:] = alpha w dout[v,h,:] + ds_pre attn_l[h,:] in bf16
  (dst-sorted edge order, as gat_pallas.py:264 per slot), and per-warp
  partials of dattn_l, summed here. Its lanes lie across (edge, head,
  column group); its first pass keeps each edge's alpha, w, w g and
  leaky_relu' factor in shared memory, from which the second forms the
  VJP and the message; `bwd_geometry` works out that layout (see the
  source's note) and the launch passes it, with a grid that fills every
  SM once.
* As `_fused_bwd` (:494-505): the message is reduced over sources by the
  CSR SpMM kernel over the transposed CSR (`t_indptr`, `t_edges`),
  dfeat_dst = der * attn_r, and dattn_r = einsum(der, feat) in plain torch.

Dropout takes an explicit keep mask [E, H] (bool or uint8, dst-sorted edge
order), as the JAX `"mask"` mode (gat_pallas.py:149-150); the mask is saved
for the backward.

The standalone segment softmax behind `ops.edge_softmax` replaces
`gat_pallas.py:_smx_fwd_kernel` (:694) and `:_smx_bwd_kernel` (:712), with
the contract of `gat_pallas.edge_softmax` (:786-806): f32 scores [E] or
[E, H] in dst-sorted edge order in, alpha per dst segment out, in the same
shape. `edge_softmax_fwd` subtracts the segment's own max (the TPU kernel
subtracts its block's, :700); `edge_softmax_bwd` gives
ds = alpha * dalpha - alpha * sum_seg(alpha * dalpha), all f32. Rows
without in-edges own no score and write nothing.

Each kernel has a plain PyTorch version here (`plain_gat_fwd`,
`plain_gat_bwd`, `plain_edge_softmax_fwd`, `plain_edge_softmax_bwd`) with
the same rounding: bf16 features, bf16 er, a bf16 message; the softmax in
f32. A wrapper takes it only for a tensor on the CPU; for a CUDA tensor
it launches the kernel or raises. `counts` records kernel launches; plain
calls on CUDA tensors go to `cuda_build.counts`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from glnn_tpu_torch.ops import cuda_build, spmm_cuda
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids

KERNELS = ("gat_fwd", "gat_bwd", "edge_softmax_fwd", "edge_softmax_bwd")
counts = {name: 0 for name in KERNELS}

WARPS_PER_BLOCK = 8      # kWarps in gat_csr.cu
BWD_CACHE_BYTES = 4096   # shared memory per warp for gat_bwd's per-edge terms
# per-head widths the kernels take: D / VEC <= 128, VEC the largest power
# of two <= 8 dividing D (gat_csr.cu `geometry`)
_MAX_GROUPS = 128

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gat_fwd": [_vp] * 6 + [_cf, _cf] + [_vp] * 3 + [_ci] * 3 + [_vp],
    "gat_bwd": [_vp] * 6 + [_cf, _cf] + [_vp] * 7 + [_ci] * 10 + [_vp],
    "gat_bwd_blocks_per_sm": [_ci] * 4,
    "edge_softmax_fwd": [_vp] * 3 + [_ci] * 2 + [_vp],
    "edge_softmax_bwd": [_vp] * 4 + [_ci] * 2 + [_vp],
}
_blocks_per_sm: dict = {}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class BwdGeometry(NamedTuple):
    vec: int     # bf16 features per load (a power of two <= 8 dividing D)
    reps: int    # loads per lane and head, strided by lh * vec
    lh: int      # lanes per head
    hp: int      # heads per pass over a row's edges
    slots: int   # edges walked at once
    kcache: int  # edges per row whose terms stay in shared memory


def bwd_geometry(h: int, d: int, align: int = 16) -> BwdGeometry:
    """gat_bwd's lane layout for H = h heads of width D = d, given feature
    and message base addresses aligned to `align` bytes: lanes across
    (edge slot, head, column group), so that all heads share one pass when
    H * lh <= 32, and 32 // (hp * lh) edges are walked at once."""
    vec = 8
    while vec > 1 and (d % vec or align % (2 * vec)):
        vec //= 2
    groups = d // vec
    reps = 1
    while reps * 32 < groups:
        reps *= 2
    lh = -(-groups // reps)
    hp = min(h, 32 // lh)
    return BwdGeometry(vec, reps, lh, hp, 32 // (hp * lh),
                       BWD_CACHE_BYTES // (16 * hp))


def supported_width(d: int) -> bool:
    vec = 8
    while d % vec:
        vec //= 2
    return d // vec <= _MAX_GROUPS


def _check(indptr, senders, feat_b, el, er_b, keep):
    if feat_b.dtype != torch.bfloat16 or feat_b.dim() != 3:
        raise TypeError(f"feat must be bf16 [N, H, D], got {feat_b.dtype} "
                        f"{tuple(feat_b.shape)}")
    n, h, d = feat_b.shape
    if el.dtype != torch.float32 or el.shape != (n, h):
        raise TypeError(f"el must be f32 [{n}, {h}]")
    if er_b.dtype != torch.bfloat16 or er_b.dim() != 2 or er_b.shape[1] != h:
        raise TypeError(f"er must be bf16 [rows, {h}]")
    for name, t in (("indptr", indptr), ("senders", senders)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("indptr", indptr), ("senders", senders), ("el", el),
                    ("er", er_b)):
        if t.device != feat_b.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feat_b.device}")
    if indptr.numel() < er_b.shape[0] + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries for "
                         f"{er_b.shape[0]} rows")
    if keep is not None and (keep.dtype not in (torch.bool, torch.uint8)
                             or keep.shape != (senders.numel(), h)):
        raise TypeError(f"keep must be bool or uint8 [{senders.numel()}, {h}]")
    if keep is not None and keep.device != feat_b.device:
        raise ValueError(f"keep must lie on {feat_b.device}")
    if feat_b.is_cuda and not supported_width(d):
        raise ValueError(f"the GAT kernels take per-head widths D with "
                         f"D / VEC <= {_MAX_GROUPS} (VEC the largest power "
                         f"of two <= 8 dividing D); got D = {d}")


def _keep_bytes(keep):
    if keep is None:
        return None
    return keep.contiguous().view(torch.uint8)


def _scores(indptr, senders, el, er_b, keep, inv_keep, slope, n_rows):
    """Per-edge (src, dst, s_pre, s, w) in dst-sorted order, f32 [E, H]."""
    src = senders.long()
    dst = row_ids(indptr, n_rows)
    s_pre = el.index_select(0, src) + er_b.float().index_select(0, dst)
    s = torch.where(s_pre >= 0, s_pre, slope * s_pre)
    w = keep.float() * inv_keep if keep is not None else torch.ones_like(s)
    return src, dst, s_pre, s, w


def plain_gat_fwd(indptr, senders, feat_b, el, er_b, keep=None,
                  inv_keep=1.0, slope=0.2):
    """Plain version of `gat_fwd`: (out f32 [N, H, D], max, denom f32
    [N, H]); rows without in-edges give zeros."""
    note_plain(feat_b)
    n_rows, h = er_b.shape
    src, dst, _, s, w = _scores(indptr, senders, el, er_b, keep, inv_keep,
                                slope, n_rows)
    smax = s.new_zeros((n_rows, h)).scatter_reduce_(
        0, dst[:, None].expand(-1, h), s, "amax", include_self=False)
    ex = torch.exp(s - smax.index_select(0, dst))
    denom = s.new_zeros((n_rows, h)).index_add_(0, dst, ex)
    alpha = ex / denom.index_select(0, dst) * w
    msgs = feat_b.index_select(0, src).float() * alpha[..., None]
    out = msgs.new_zeros((n_rows,) + tuple(feat_b.shape[1:]))
    return out.index_add_(0, dst, msgs), smax, denom


def plain_gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                  smax, denom, dout, al_b):
    """Plain version of `gat_bwd`: (der f32 [N, H], msg bf16 [E, H, D],
    dattn_l f32 [H, D]); the softmax-VJP chain in f32."""
    note_plain(feat_b)
    n_rows, h = er_b.shape
    src, dst, s_pre, s, w = _scores(indptr, senders, el, er_b, keep, inv_keep,
                                    slope, n_rows)
    alpha = torch.exp(s - smax.index_select(0, dst)) / denom.index_select(0,
                                                                          dst)
    fb = feat_b.index_select(0, src).float()                    # [E, H, D]
    go = dout.index_select(0, dst)
    g = (fb * go).sum(-1)                                       # [E, H]
    t = alpha.new_zeros((n_rows, h)).index_add_(0, dst, alpha * w * g)
    ds = alpha * (w * g - t.index_select(0, dst))
    ds_pre = torch.where(s_pre >= 0, ds, slope * ds)
    der = alpha.new_zeros((n_rows, h)).index_add_(0, dst, ds_pre)
    msg = ((alpha * w)[..., None] * go
           + ds_pre[..., None] * al_b.float()[None]).to(torch.bfloat16)
    dal = (ds_pre[..., None] * fb).sum(0)
    return der, msg, dal


def _launch_fwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope):
    n_rows, (_, h, d) = er_b.shape[0], feat_b.shape
    f32 = dict(dtype=torch.float32, device=feat_b.device)
    out = torch.empty((n_rows, h, d), **f32)
    smax = torch.empty((n_rows, h), **f32)
    denom = torch.empty((n_rows, h), **f32)
    keep = _keep_bytes(keep)
    lib = cuda_build.load("gat", _SIGNATURES)
    cuda_build.launch(
        "gat_fwd", lib.gat_fwd, feat_b.device, indptr.data_ptr(),
        senders.data_ptr(), feat_b.data_ptr(), el.data_ptr(), er_b.data_ptr(),
        None if keep is None else keep.data_ptr(), inv_keep, slope,
        out.data_ptr(), smax.data_ptr(), denom.data_ptr(), n_rows, h, d)
    counts["gat_fwd"] += 1
    return out, smax, denom


def _bwd_blocks(lib, geo: BwdGeometry, device: torch.device) -> int:
    """Blocks of gat_bwd that fill every SM of `device` once."""
    key = (device, geo.vec, geo.reps, geo.kcache, geo.hp)
    if key not in _blocks_per_sm:
        with torch.cuda.device(device):
            per_sm = lib.gat_bwd_blocks_per_sm(geo.vec, geo.reps, geo.kcache,
                                               geo.hp)
            props = torch.cuda.get_device_properties(device)
        if per_sm <= 0:
            raise RuntimeError(f"gat_bwd occupancy query failed: CUDA error "
                               f"{-per_sm}")
        _blocks_per_sm[key] = per_sm * props.multi_processor_count
    return _blocks_per_sm[key]


def _launch_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                smax, denom, dout, al_b):
    n_rows, (_, h, d) = er_b.shape[0], feat_b.shape
    n_edges = senders.numel()
    dev = feat_b.device
    der = torch.empty((n_rows, h), dtype=torch.float32, device=dev)
    msg = torch.empty((n_edges, h, d), dtype=torch.bfloat16, device=dev)
    geo = bwd_geometry(h, d, align=feat_b.data_ptr() | msg.data_ptr())
    lib = cuda_build.load("gat", _SIGNATURES)
    n_blocks = max(1, min(-(-n_rows // WARPS_PER_BLOCK),
                          _bwd_blocks(lib, geo, dev)))
    part = torch.empty((n_blocks * WARPS_PER_BLOCK, h, d),
                       dtype=torch.float32, device=dev)
    keep = _keep_bytes(keep)
    dout = dout.float().contiguous()
    al_b = al_b.contiguous()
    cuda_build.launch(
        "gat_bwd", lib.gat_bwd, dev, indptr.data_ptr(), senders.data_ptr(),
        feat_b.data_ptr(), el.data_ptr(), er_b.data_ptr(),
        None if keep is None else keep.data_ptr(), inv_keep, slope,
        smax.data_ptr(), denom.data_ptr(), dout.data_ptr(), al_b.data_ptr(),
        der.data_ptr(), msg.data_ptr(), part.data_ptr(), n_rows, h, d,
        n_blocks, *geo)
    counts["gat_bwd"] += 1
    return der, msg, part.sum(0)


def gat_fwd(indptr, senders, feat_b, el, er_b, keep=None, inv_keep=1.0,
            slope=0.2):
    """Fused attention forward over the CSC (indptr, senders), whose
    `senders` holds exactly its indptr[-1] edges: feat_b bf16
    [N, H, D], el f32 [N, H], er_b bf16 [N, H], keep [E, H] or None.
    Returns (out f32 [N, H, D], max f32 [N, H], denom f32 [N, H])."""
    _check(indptr, senders, feat_b, el, er_b, keep)
    if feat_b.is_cuda:
        return _launch_fwd(indptr, senders, feat_b.contiguous(), el, er_b,
                           keep, float(inv_keep), float(slope))
    return plain_gat_fwd(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                         slope)


def gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope, smax,
            denom, dout, al_b):
    """Fused attention backward: the forward's inputs, its max and denom,
    dout f32 [N, H, D] and bf16 attn_l [H, D]. Returns (der f32 [N, H],
    msg bf16 [E, H, D] in dst-sorted edge order, dattn_l f32 [H, D])."""
    _check(indptr, senders, feat_b, el, er_b, keep)
    if feat_b.is_cuda:
        return _launch_bwd(indptr, senders, feat_b.contiguous(), el, er_b,
                           keep, float(inv_keep), float(slope), smax, denom,
                           dout, al_b)
    return plain_gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                         slope, smax, denom, dout.float(), al_b)


def prep(feat, attn_l, attn_r):
    """(feat_b, el, er_b, al_b): bf16 features, el = <feat_b, bf16 attn_l>
    in f32, er in f32 rounded once to bf16, bf16 attn_l."""
    feat_b = feat.to(torch.bfloat16).contiguous()
    al_b = attn_l.to(torch.bfloat16)
    el = (feat_b.float() * al_b.float()[None]).sum(-1)
    er_b = (feat.float() * attn_r.float()[None]).sum(-1).to(torch.bfloat16)
    return feat_b, el, er_b.contiguous(), al_b


class _GATAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feat, attn_l, attn_r, g, keep, inv_keep, slope):
        feat_b, el, er_b, al_b = prep(feat, attn_l, attn_r)
        out, smax, denom = gat_fwd(g.indptr, g.senders, feat_b, el, er_b,
                                   keep, inv_keep, slope)
        ctx.save_for_backward(feat, attn_r, feat_b, el, er_b, al_b, keep,
                              smax, denom)
        ctx.g, ctx.inv_keep, ctx.slope = g, inv_keep, slope
        ctx.attn_l_dtype = attn_l.dtype
        return out.to(feat.dtype)

    @staticmethod
    def backward(ctx, dout):
        feat, attn_r, feat_b, el, er_b, al_b, keep, smax, denom = \
            ctx.saved_tensors
        g = ctx.g
        n, h, d = feat.shape
        der, msg, dal = gat_bwd(g.indptr, g.senders, feat_b, el, er_b, keep,
                                ctx.inv_keep, ctx.slope, smax, denom, dout,
                                al_b)
        dfeat_src = spmm_cuda.csr_sum_bf16(g.t_indptr, g.t_edges,
                                           msg.view(-1, h * d), n)
        dfeat = (dfeat_src.view(n, h, d)
                 + der[:, :, None] * attn_r.float()[None])
        dattn_r = torch.einsum("nh,nhd->hd", der, feat.float())
        return (dfeat.to(feat.dtype), dal.to(ctx.attn_l_dtype),
                dattn_r.to(attn_r.dtype), None, None, None, None)


def gat_attention(g, feat, attn_l, attn_r, slope: float = 0.2, keep=None,
                  inv_keep: float = 1.0):
    """The fused attention layer: feat [N, H, D] (= Wh), attn_l/attn_r
    [H, D], keep [E, H] or None with inv_keep = 1 / keep probability.
    Returns [N, H, D] in feat's dtype."""
    return _GATAttention.apply(feat, attn_l, attn_r, g, keep, float(inv_keep),
                               float(slope))


# ---- the standalone segment softmax ---------------------------------------

def _check_edge_rows(indptr, n_rows, *edge_arrays):
    for t in edge_arrays:
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"expected f32 [E, H], got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.shape != edge_arrays[0].shape or t.device != indptr.device:
            raise ValueError("the edge arrays must share one shape and lie "
                             "on indptr's device")
    if indptr.dtype != torch.int32 or not indptr.is_contiguous():
        raise TypeError(f"indptr must be contiguous int32, got {indptr.dtype}")
    if indptr.numel() < n_rows + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries for "
                         f"{n_rows} rows")


def _segment_sum(values, dst, n_rows):
    """Per-dst sums of f32 [E, H] values, accumulated in f64 and rounded
    once to f32: a single f32 accumulator (index_add_) loses about 1e-5 of
    a 20,000-edge segment's sum of exponentials, ten times the kernel's
    error, so the plain version would not be a yardstick on hub rows."""
    acc = values.new_zeros((n_rows, values.shape[1]), dtype=torch.float64)
    return acc.index_add_(0, dst, values.double()).float()


def plain_edge_softmax_fwd(indptr, scores, n_rows):
    """Plain version of `edge_softmax_fwd`: exp(s - segment max) / segment
    sum per dst row and head, f32 [E, H] (the sums in f64)."""
    note_plain(scores)
    h = scores.shape[1]
    dst = row_ids(indptr, n_rows)
    smax = scores.new_zeros((n_rows, h)).scatter_reduce_(
        0, dst[:, None].expand(-1, h), scores, "amax", include_self=False)
    ex = torch.exp(scores - smax.index_select(0, dst))
    den = _segment_sum(ex, dst, n_rows)
    return ex / den.index_select(0, dst)


def plain_edge_softmax_bwd(indptr, alpha, dalpha, n_rows):
    """Plain version of `edge_softmax_bwd`: alpha * dalpha - alpha *
    sum_seg(alpha * dalpha), f32 [E, H] (the sums in f64)."""
    note_plain(alpha)
    dst = row_ids(indptr, n_rows)
    ag = alpha * dalpha
    t = _segment_sum(ag, dst, n_rows)
    return ag - alpha * t.index_select(0, dst)


def edge_softmax_fwd(indptr, scores, n_rows):
    """Segment softmax over the CSC rows: scores f32 [E, H] (E =
    indptr[n_rows], dst-sorted) -> alpha f32 [E, H]."""
    _check_edge_rows(indptr, n_rows, scores)
    if scores.is_cuda:
        scores = scores.contiguous()
        alpha = torch.empty_like(scores)
        lib = cuda_build.load("gat", _SIGNATURES)
        cuda_build.launch("edge_softmax_fwd", lib.edge_softmax_fwd,
                          scores.device, indptr.data_ptr(), scores.data_ptr(),
                          alpha.data_ptr(), n_rows, scores.shape[1])
        counts["edge_softmax_fwd"] += 1
        return alpha
    return plain_edge_softmax_fwd(indptr, scores, n_rows)


def edge_softmax_bwd(indptr, alpha, dalpha, n_rows):
    """Its VJP: alpha and dalpha f32 [E, H] -> ds f32 [E, H]."""
    _check_edge_rows(indptr, n_rows, alpha, dalpha)
    if alpha.is_cuda:
        alpha, dalpha = alpha.contiguous(), dalpha.contiguous()
        ds = torch.empty_like(alpha)
        lib = cuda_build.load("gat", _SIGNATURES)
        cuda_build.launch("edge_softmax_bwd", lib.edge_softmax_bwd,
                          alpha.device, indptr.data_ptr(), alpha.data_ptr(),
                          dalpha.data_ptr(), ds.data_ptr(), n_rows,
                          alpha.shape[1])
        counts["edge_softmax_bwd"] += 1
        return ds
    return plain_edge_softmax_bwd(indptr, alpha, dalpha, n_rows)


class _EdgeSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, scores, g):
        alpha = edge_softmax_fwd(g.indptr, scores, g.n_nodes)
        ctx.save_for_backward(alpha)
        ctx.g = g
        return alpha

    @staticmethod
    def backward(ctx, dalpha):
        (alpha,) = ctx.saved_tensors
        return edge_softmax_bwd(ctx.g.indptr, alpha, dalpha.float(),
                                ctx.g.n_nodes), None


def edge_softmax(g, scores):
    """Softmax of scores [E] or [E, H] (dst-sorted edge order) over each
    dst's in-edges, in the same shape and dtype; the kernels run in f32."""
    if scores.dim() not in (1, 2) or scores.shape[0] != g.n_edges:
        raise ValueError(f"edge_softmax takes scores [{g.n_edges}] or "
                         f"[{g.n_edges}, H], got {tuple(scores.shape)}")
    s2 = scores[:, None] if scores.dim() == 1 else scores
    alpha = _EdgeSoftmax.apply(s2.float(), g).to(scores.dtype)
    return alpha[:, 0] if scores.dim() == 1 else alpha
