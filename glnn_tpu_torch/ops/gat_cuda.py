"""Fused GAT attention on the GPU: the hand-written CUDA kernels behind
`ops.gat_attention`.

Replaces the TPU kernels `glnn_tpu/ops/gat_pallas.py:_gat_fwd_kernel` (:158)
and `:_gat_bwd_kernel` (:187). For each dst v and head h:
s = leaky_relu(el[u,h] + er[v,h]), alpha = softmax of s over v's in-edges,
dropout on alpha after the normalisation (dgl GATConv), and
out[v,h,:] = sum alpha * feat[u,h,:].

* `gat_prep` (csrc/gat_csr.cu) reads the f32 features once and writes the
  bf16 features, el[u,h] = <bf16 feat[u,h,:], bf16 attn_l[h,:]> summed in
  f32 (the TPU kernel's score matmul, gat_pallas.py:118, with the same
  rounding, but once per node, where the TPU kernel computes it per slot
  inside its body) and er[v,h] in f32 rounded once to bf16, as `_prep`
  (:409-420) computes it outside its kernel. `prep` launches it on CUDA
  tensors; its plain version is `plain_prep`.
* `gat_fwd` walks the dst-sorted CSC a 32-edge chunk at a time: lane j
  scores chunk edge j for up to 8 heads (the segment max first, not the
  TPU's block max, then each term once with that max and the denominator
  of the undropped weights), and lanes across (edge slot, head, column
  group) accumulate the bf16 source rows in f32; it also writes the
  per-dst max and denominator [N, H] for the backward. A row of more than
  T edges is split across warps by the CSR's hub plan (kept on the Graph
  or the halo shard; the GAT layer's is cut at T = `GAT_CHUNK`, the
  softmax's at `spmm_cuda.HUB_CHUNK`): the chunks' maxima first
  (`gat_fwd_hub_max`), then each chunk's sums with the row's final max in
  `gat_fwd`, then the split rows' sums in chunk order (`gat_fwd_combine`),
  three launches counted under `gat_fwd`; one on a CSR without such rows.
* `gat_bwd` recomputes alpha from the same inputs and the saved max and
  denominator and runs the f32 softmax VJP: der [N, H] f32, the per-edge
  message msg[e,h,:] = alpha w dout[v,h,:] + ds_pre attn_l[h,:] in bf16
  (dst-sorted edge order, as gat_pallas.py:264 per slot), and per-warp
  partials of dattn_l, summed here. Its first pass keeps each edge's
  alpha, w, w g and leaky_relu' factor in shared memory, from which the
  second forms the VJP and the message. On the forward's hub plan a split
  row's chunks first write their parts of t (`gat_bwd_hub_t`), then each
  chunk runs the second pass with its row's t in `gat_bwd`, and
  `gat_bwd_combine` sums the split rows' der in chunk order: three
  launches counted under `gat_bwd`, one on a CSR without such rows.
* `fwd_geometry` / `bwd_geometry` work out both kernels' lane layout (see
  the source's note) and the launch passes it, with a grid that fills
  every SM once.
* As `_fused_bwd` (:494-505): the message is reduced over sources by the
  CSR SpMM kernel over the transposed CSR (`t_indptr`, `t_edges`),
  dfeat_dst = der * attn_r, and dattn_r = einsum(der, feat) in plain torch.

Dropout (`keep`, dst-sorted edge order) is one of:
* None: no dropout;
* a keep mask [E, H], bool or uint8, as the JAX `"mask"` mode
  (gat_pallas.py:149-150);
* a seed, an int64 tensor of one element on the features' device: both
  kernels generate the keep bits in their bodies with Philox4x32-10
  (`philox_keep` is the same in plain torch), as the TPU kernels generate
  theirs from the hardware PRNG (:141-155), so no [E, H] tensor exists;
  the kernels read the seed through a pointer, so drawing it needs no
  host sync. Edge e keeps head h iff word h & 3 of Philox(counter
  (edge_base + e, h >> 2, 0, 0), key (seed lo, seed hi)) <
  keep_threshold(keep), the JAX rule (:312). edge_base (uint32, default
  0) is the global id of the CSR's first edge: a shard of a halo-sharded
  graph, whose edges are a contiguous slice of the global dst-sorted
  order, passes its own and so draws the single-device bits of the same
  edges. The seed is saved for the backward in place of a mask.
A kept edge's weight is inv_keep (keep = 1 / inv_keep).

The standalone segment softmax behind `ops.edge_softmax` replaces
`gat_pallas.py:_smx_fwd_kernel` (:694) and `:_smx_bwd_kernel` (:712), with
the contract of `gat_pallas.edge_softmax` (:786-806): f32 scores [E] or
[E, H] in dst-sorted edge order in, alpha per dst segment out, in the same
shape. `edge_softmax_fwd` subtracts the segment's own max (the TPU kernel
subtracts its block's, :700) and reads each short row's scores once
(`softmax_geometry` packs several rows into a warp); on the CSR's hub plan
a split row's chunk maxima and sums come first (`edge_softmax_hub_pass`),
three launches counted under `edge_softmax_fwd`. `edge_softmax_bwd`
gives ds = alpha * dalpha - alpha * sum_seg(alpha * dalpha), all f32; on
the forward's plan a split row's chunks first write their parts of the sum
(`edge_softmax_bwd_hub_t`), then each chunk writes ds over its edges with
its row's sum, two launches counted under `edge_softmax_bwd`. Rows
without in-edges own no score and write nothing.

Each kernel has a plain PyTorch version here (`plain_prep`,
`plain_gat_fwd`, `plain_gat_bwd`, `plain_edge_softmax_fwd`,
`plain_edge_softmax_bwd`) with the same rounding: bf16 features, bf16 er,
a bf16 message; the softmax in f32. A wrapper takes it only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises. `counts`
records kernel launches, and for the two GAT kernels also the launches
per dropout mode (`gat_fwd_seed`, `gat_fwd_mask`, `gat_bwd_seed`,
`gat_bwd_mask`); plain calls on CUDA tensors go to `cuda_build.counts`.
Each wrapper call, plain or launched, runs in a span `kernel.<name>` of
`counts` (recorded only under a profiler, utils/profiling.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from glnn_tpu_torch.ops import cuda_build, spmm_cuda
from glnn_tpu_torch.ops.cuda_build import note_plain, row_ids
from glnn_tpu_torch.utils.profiling import span

KERNELS = ("gat_prep", "gat_fwd", "gat_bwd", "edge_softmax_fwd",
           "edge_softmax_bwd")
DROP_MODES = ("gat_fwd_seed", "gat_fwd_mask", "gat_bwd_seed", "gat_bwd_mask")
counts = {name: 0 for name in KERNELS + DROP_MODES}

WARPS_PER_BLOCK = 8      # kWarps in gat_csr.cu
FWD_MAX_HEADS = 8        # heads per gat_fwd pass (kFwdMaxHeads)
FWD_MAX_SLOTS = 4        # edges gat_fwd walks at once, where a load allows
BWD_CACHE_BYTES = 4096   # shared memory per warp for gat_bwd's per-edge terms
SOFTMAX_REGS = 8         # scores per lane in edge_softmax_fwd (kSoftmaxRegs)
# T of the GAT layer's hub plan (gat_fwd and gat_bwd): rows of more edges
# are split across warps. On chip_smoke.py's hub graph T = 128 gave the
# fastest step of the two kernels at both GAT shapes, device ms (8, 16)
# 1.352 against 1.418 at T = 256 and 1.681 at 512, (1, 40) 0.627 against
# 0.656 and 0.722: gat_bwd is 9% faster than at 256, gat_fwd 4% slower
# (tools/sweep_cuda_kernels.py --kernels gat_fwd_hub,gat_bwd_hub; H100
# 80GB HBM3, 700 W). The softmax, the SpMMs and the source reduce keep
# spmm_cuda.HUB_CHUNK
GAT_CHUNK = 128
# per-head widths the kernels take: D / VEC <= 128, VEC the largest power
# of two <= 8 dividing D
_MAX_GROUPS = 128

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_cf = ctypes.c_float
_SIGNATURES = {
    "gat_prep": [_vp] * 6 + [_ci] * 3 + [_vp],
    "gat_fwd": [_vp] * 7 + [_cu, _cu, _cf, _cf] + [_vp] * 10 + [_ci] * 11
    + [_vp],
    "gat_fwd_hub_max": [_vp] * 3 + [_cf] + [_vp] * 4 + [_ci] * 2 + [_vp],
    "gat_fwd_combine": [_vp] * 8 + [_ci] * 3 + [_vp],
    "gat_bwd_hub_t": [_vp] * 6 + [_cu, _cu, _cf, _cf] + [_vp] * 7
    + [_ci] * 8 + [_vp],
    "gat_bwd": [_vp] * 7 + [_cu, _cu, _cf, _cf] + [_vp] * 13 + [_ci] * 12
    + [_vp],
    "gat_bwd_combine": [_vp] * 4 + [_ci] * 2 + [_vp],
    "gat_fwd_blocks_per_sm": [_ci] * 4,
    "gat_bwd_blocks_per_sm": [_ci] * 5,
    "edge_softmax_hub_pass": [_ci] + [_vp] * 6 + [_ci] * 2 + [_vp],
    "edge_softmax_fwd": [_vp] * 8 + [_ci] * 5 + [_vp],
    "edge_softmax_bwd_hub_t": [_vp] * 4 + [_ci] * 2 + [_vp],
    "edge_softmax_bwd": [_vp] * 8 + [_ci] * 4 + [_vp],
}
_blocks_per_sm: dict = {}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


# ---- Philox dropout -------------------------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def keep_threshold(keep: float) -> int:
    """Philox words below this are kept: min(keep * 2**32, 2**32 - 1), the
    rule of gat_pallas._drop_spec_arg (:312)."""
    return min(int(float(keep) * 2.0 ** 32), 2 ** 32 - 1)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for uint32 values in int64 tensors: x
    is split into 16-bit halves, so no product passes 2**48."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32(ctr, key):
    """Philox4x32-10 of four uint32 counter words under two key words, each
    an int64 tensor (or int) holding a uint32 value; returns four words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_keep(seed: torch.Tensor, n_edges: int, heads: int,
                keep: float, edge_base: int = 0) -> torch.Tensor:
    """The keep mask [E, H] (bool, dst-sorted edge order) that the kernels
    generate from `seed` (int64, one element): edge e keeps head h iff word
    h & 3 of Philox4x32-10 at counter (edge_base + e mod 2**32, h >> 2, 0,
    0) under key (seed lo, seed hi) is below keep_threshold(keep). Rows
    b.. of the mask at edge_base 0 are the mask at edge_base b."""
    s = seed.reshape(-1)[:1].long()
    key = (s & _U32, (s >> 32) & _U32)
    e = (torch.arange(n_edges, dtype=torch.int64, device=seed.device)
         + int(edge_base)) & _U32
    zero = torch.zeros_like(e)
    words = [torch.stack(philox4x32((e, torch.full_like(e, c), zero, zero),
                                    key), 1)
             for c in range(-(-heads // 4))]
    return torch.cat(words, 1)[:, :heads] < keep_threshold(keep)


def _is_seed(keep) -> bool:
    return keep is not None and keep.dtype == torch.int64


# ---- geometry -------------------------------------------------------------

class FwdGeometry(NamedTuple):
    vec: int     # bf16 features per load (a power of two <= 8 dividing D)
    reps: int    # loads per lane and head, strided by lh * vec
    lh: int      # lanes per head
    hp: int      # heads per pass over a row's edges
    slots: int   # edges walked at once


class BwdGeometry(NamedTuple):
    vec: int
    reps: int
    lh: int
    hp: int
    slots: int
    kcache: int  # edges per row whose terms stay in shared memory


def _lanes(h: int, d: int, align: int, max_heads: int, max_vec: int = 8):
    """(vec, reps, lh, hp, slots): lanes across (edge slot, head, column
    group), loads of the widest vec <= max_vec that d and the alignment
    allow, up to max_heads heads in one pass when H * lh <= 32, and
    32 // (hp * lh) edges walked at once."""
    vec = max_vec
    while vec > 1 and (d % vec or align % (2 * vec)):
        vec //= 2
    groups = d // vec
    reps = 1
    while reps * 32 < groups:
        reps *= 2
    lh = -(-groups // reps)
    hp = min(h, 32 // lh, max_heads)
    return vec, reps, lh, hp, 32 // (hp * lh)


def fwd_geometry(h: int, d: int, align: int = 16) -> FwdGeometry:
    """gat_fwd's lane layout for H = h heads of width D = d, given a feature
    base address aligned to `align` bytes: at most FWD_MAX_HEADS heads per
    pass, and the widest load (8 or 4 values) whose layout walks at most
    FWD_MAX_SLOTS edges at once, else the widest: folding more slots'
    sums costs more than wider loads save ((1, 40): 8-byte loads, 3 slots,
    10-15% faster than 16-byte loads and 6 slots on the card,
    tools/sweep_cuda_kernels.py)."""
    layouts = [_lanes(h, d, align, FWD_MAX_HEADS, v) for v in (8, 4)]
    fit = [g for g in layouts if g[4] <= FWD_MAX_SLOTS]
    return FwdGeometry(*(fit or layouts)[0])


def bwd_geometry(h: int, d: int, align: int = 16) -> BwdGeometry:
    """gat_bwd's lane layout, given feature and message base addresses
    aligned to `align` bytes (all heads in one pass where they fit); four
    f32 terms of each row's first kcache edges stay in BWD_CACHE_BYTES per
    warp."""
    lanes = _lanes(h, d, align, h)
    return BwdGeometry(*lanes, BWD_CACHE_BYTES // (16 * lanes[3]))


def supported_width(d: int) -> bool:
    vec = 8
    while d % vec:
        vec //= 2
    return d // vec <= _MAX_GROUPS


def _check(indptr, senders, feat_b, el, er_b, keep, edge_base):
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
    if not 0 <= edge_base < 2 ** 32:
        raise ValueError(f"edge_base must be a uint32, got {edge_base}")
    if keep is None:
        return
    if _is_seed(keep):
        if keep.numel() != 1:
            raise TypeError(f"a dropout seed is one int64, got "
                            f"{tuple(keep.shape)}")
    elif (keep.dtype not in (torch.bool, torch.uint8)
          or keep.shape != (senders.numel(), h)):
        raise TypeError(f"keep must be a bool or uint8 [{senders.numel()}, "
                        f"{h}] mask or an int64 seed")
    if keep.device != feat_b.device:
        raise ValueError(f"keep must lie on {feat_b.device}")
    if feat_b.is_cuda and not supported_width(d):
        raise ValueError(f"the GAT kernels take per-head widths D with "
                         f"D / VEC <= {_MAX_GROUPS} (VEC the largest power "
                         f"of two <= 8 dividing D); got D = {d}")


def _plain_mask(keep, n_edges, heads, inv_keep, edge_base):
    """The keep mask a plain version applies: the seed's Philox mask, or the
    mask as given."""
    if _is_seed(keep):
        return philox_keep(keep, n_edges, heads, 1.0 / inv_keep, edge_base)
    return keep


def _drop_args(keep, inv_keep):
    """(mask pointer, seed pointer, threshold, the counter of the mode) for
    a launch; the mask is kept alive by the caller (the edge base goes
    beside them)."""
    if keep is None:
        return None, None, 0, None
    if _is_seed(keep):
        return (None, keep.data_ptr(), keep_threshold(1.0 / inv_keep),
                "seed")
    return keep.data_ptr(), None, 0, "mask"


def _scores(indptr, senders, el, er_b, keep, inv_keep, slope, n_rows,
            edge_base):
    """Per-edge (src, dst, s_pre, s, w) in dst-sorted order, f32 [E, H]."""
    src = senders.long()
    dst = row_ids(indptr, n_rows)
    s_pre = el.index_select(0, src) + er_b.float().index_select(0, dst)
    s = torch.where(s_pre >= 0, s_pre, slope * s_pre)
    keep = _plain_mask(keep, senders.numel(), el.shape[1], inv_keep,
                       edge_base)
    w = keep.float() * inv_keep if keep is not None else torch.ones_like(s)
    return src, dst, s_pre, s, w


def plain_gat_fwd(indptr, senders, feat_b, el, er_b, keep=None,
                  inv_keep=1.0, slope=0.2, edge_base=0):
    """Plain version of `gat_fwd`: (out f32 [N, H, D], max, denom f32
    [N, H]); rows without in-edges give zeros."""
    note_plain(feat_b)
    n_rows, h = er_b.shape
    src, dst, _, s, w = _scores(indptr, senders, el, er_b, keep, inv_keep,
                                slope, n_rows, edge_base)
    smax = s.new_zeros((n_rows, h)).scatter_reduce_(
        0, dst[:, None].expand(-1, h), s, "amax", include_self=False)
    ex = torch.exp(s - smax.index_select(0, dst))
    denom = s.new_zeros((n_rows, h)).index_add_(0, dst, ex)
    alpha = ex / denom.index_select(0, dst) * w
    msgs = feat_b.index_select(0, src).float() * alpha[..., None]
    out = msgs.new_zeros((n_rows,) + tuple(feat_b.shape[1:]))
    return out.index_add_(0, dst, msgs), smax, denom


def plain_gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                  smax, denom, dout, al_b, edge_base=0):
    """Plain version of `gat_bwd`: (der f32 [N, H], msg bf16 [E, H, D],
    dattn_l f32 [H, D]); the softmax-VJP chain in f32."""
    note_plain(feat_b)
    n_rows, h = er_b.shape
    src, dst, s_pre, s, w = _scores(indptr, senders, el, er_b, keep, inv_keep,
                                    slope, n_rows, edge_base)
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


def _blocks(lib, geo, device: torch.device, hub: bool = False) -> int:
    """Blocks of gat_fwd (a FwdGeometry) or gat_bwd (a BwdGeometry) that
    fill every SM of `device` once; `hub`: the instantiation that splits
    hub rows."""
    key = (device, type(geo).__name__, geo, hub)
    if key not in _blocks_per_sm:
        with torch.cuda.device(device):
            if isinstance(geo, FwdGeometry):
                per_sm = lib.gat_fwd_blocks_per_sm(geo.vec, geo.reps, geo.hp,
                                                   int(hub))
            else:
                per_sm = lib.gat_bwd_blocks_per_sm(geo.vec, geo.reps,
                                                   geo.kcache, geo.hp,
                                                   int(hub))
            props = torch.cuda.get_device_properties(device)
        if per_sm <= 0:
            raise RuntimeError(f"gat occupancy query failed: CUDA error "
                               f"{-per_sm}")
        _blocks_per_sm[key] = per_sm * props.multi_processor_count
    return _blocks_per_sm[key]


def _grid(lib, geo, device, n_rows, hub=False):
    return max(1, min(-(-n_rows // WARPS_PER_BLOCK),
                      _blocks(lib, geo, device, hub)))


def _keep_arg(keep):
    if keep is None or _is_seed(keep):
        return keep
    return keep.contiguous().view(torch.uint8)


def _launch_fwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                edge_base, plan):
    """gat_fwd over the CSR; on a plan with chunks also the chunk maxima
    before it and the split rows' sums after it, each launch counted."""
    n_rows, (_, h, d) = er_b.shape[0], feat_b.shape
    dev = feat_b.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((n_rows, h, d), **f32)
    smax = torch.empty((n_rows, h), **f32)
    denom = torch.empty((n_rows, h), **f32)
    if plan is None:
        plan = spmm_cuda.hub_plan(indptr, n_rows)
    spmm_cuda.check_plan(plan, n_rows, dev)
    c = plan.n_chunks
    hub = [None] * 7
    if c:   # the chunks' maxima, sums of p and sums of p w f
        pmax = torch.empty((c, h), **f32)
        pden = torch.empty((c, h), **f32)
        pacc = torch.empty((c, h, d), **f32)
        hub = [plan.chunks.data_ptr(), plan.owner.data_ptr(),
               plan.rows.data_ptr(), plan.first.data_ptr(), pmax.data_ptr(),
               pden.data_ptr(), pacc.data_ptr()]
    keep = _keep_arg(keep)
    mask_ptr, seed_ptr, thresh, mode = _drop_args(keep, inv_keep)
    geo = fwd_geometry(h, d, align=feat_b.data_ptr())
    lib = cuda_build.load("gat", _SIGNATURES)
    if c:
        cuda_build.launch(
            "gat_fwd", lib.gat_fwd_hub_max, dev, senders.data_ptr(),
            el.data_ptr(), er_b.data_ptr(), slope, *hub[:3], hub[4], c, h)
        counts["gat_fwd"] += 1
    cuda_build.launch(
        "gat_fwd", lib.gat_fwd, dev, indptr.data_ptr(), senders.data_ptr(),
        feat_b.data_ptr(), el.data_ptr(), er_b.data_ptr(), mask_ptr,
        seed_ptr, thresh, edge_base, inv_keep, slope, out.data_ptr(),
        smax.data_ptr(), denom.data_ptr(), *hub, c, plan.chunk, n_rows, h, d,
        _grid(lib, geo, dev, n_rows + c, c > 0), *geo)
    counts["gat_fwd"] += 1
    if mode:
        counts[f"gat_fwd_{mode}"] += 1
    if c:
        cuda_build.launch(
            "gat_fwd", lib.gat_fwd_combine, dev, *hub[2:7], out.data_ptr(),
            smax.data_ptr(), denom.data_ptr(), plan.rows.numel(), h, d)
        counts["gat_fwd"] += 1
    return out, smax, denom


def _launch_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                smax, denom, dout, al_b, edge_base, plan):
    """gat_bwd over the CSR; on a plan with chunks also the chunks' parts
    of t before it and the split rows' der after it, each launch
    counted."""
    n_rows, (_, h, d) = er_b.shape[0], feat_b.shape
    n_edges = senders.numel()
    dev = feat_b.device
    f32 = dict(dtype=torch.float32, device=dev)
    der = torch.empty((n_rows, h), **f32)
    msg = torch.empty((n_edges, h, d), dtype=torch.bfloat16, device=dev)
    if plan is None:
        plan = spmm_cuda.hub_plan(indptr, n_rows)
    spmm_cuda.check_plan(plan, n_rows, dev)
    c = plan.n_chunks
    geo = bwd_geometry(h, d, align=feat_b.data_ptr() | msg.data_ptr())
    lib = cuda_build.load("gat", _SIGNATURES)
    n_blocks = _grid(lib, geo, dev, n_rows + c, c > 0)
    part = torch.empty((n_blocks * WARPS_PER_BLOCK, h, d), **f32)
    keep = _keep_arg(keep)
    mask_ptr, seed_ptr, thresh, mode = _drop_args(keep, inv_keep)
    dout = dout.float().contiguous()
    al_b = al_b.contiguous()
    inputs = (feat_b.data_ptr(), el.data_ptr(), er_b.data_ptr(), mask_ptr,
              seed_ptr, thresh, edge_base, inv_keep, slope, smax.data_ptr(),
              denom.data_ptr(), dout.data_ptr())
    hub = [None] * 6
    if c:   # each chunk's part of its row's t, and of its der
        pt = torch.empty((c, h), **f32)
        pder = torch.empty((c, h), **f32)
        hub = [plan.chunks.data_ptr(), plan.owner.data_ptr(),
               plan.rows.data_ptr(), plan.first.data_ptr(), pt.data_ptr(),
               pder.data_ptr()]
        cuda_build.launch(
            "gat_bwd", lib.gat_bwd_hub_t, dev, senders.data_ptr(), *inputs,
            *hub[:3], hub[4], c, h, d, *geo[:5])
        counts["gat_bwd"] += 1
    cuda_build.launch(
        "gat_bwd", lib.gat_bwd, dev, indptr.data_ptr(), senders.data_ptr(),
        *inputs, al_b.data_ptr(), der.data_ptr(), msg.data_ptr(),
        part.data_ptr(), *hub, c, plan.chunk, n_rows, h, d, n_blocks, *geo)
    counts["gat_bwd"] += 1
    if mode:
        counts[f"gat_bwd_{mode}"] += 1
    if c:
        cuda_build.launch(
            "gat_bwd", lib.gat_bwd_combine, dev, hub[2], hub[3], hub[5],
            der.data_ptr(), plan.rows.numel(), h)
        counts["gat_bwd"] += 1
    return der, msg, part.sum(0)


@span("kernel.gat_fwd")
def gat_fwd(indptr, senders, feat_b, el, er_b, keep=None, inv_keep=1.0,
            slope=0.2, edge_base=0, plan=None):
    """Fused attention forward over the CSC (indptr, senders), whose
    `senders` holds exactly its indptr[-1] edges: feat_b bf16
    [N_src, H, D], el f32 [N_src, H], er_b bf16 [rows, H] (the dst rows),
    keep a mask [E, H], a seed or None, edge_base the seed mode's Philox
    counter of edge 0 (see the module note), `plan` the CSR's hub plan
    (`spmm_cuda.plan_of`; built here when None). Returns (out f32
    [rows, H, D], max f32 [rows, H], denom f32 [rows, H])."""
    _check(indptr, senders, feat_b, el, er_b, keep, edge_base)
    if feat_b.is_cuda:
        return _launch_fwd(indptr, senders, feat_b.contiguous(), el, er_b,
                           keep, float(inv_keep), float(slope), edge_base,
                           plan)
    return plain_gat_fwd(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                         slope, edge_base)


@span("kernel.gat_bwd")
def gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope, smax,
            denom, dout, al_b, edge_base=0, plan=None):
    """Fused attention backward: the forward's inputs, its max and denom,
    dout f32 [rows, H, D] and bf16 attn_l [H, D]; `plan` the CSR's hub plan,
    the forward's (`spmm_cuda.plan_of`; built here when None, two host
    syncs). Returns (der f32 [rows, H], msg bf16 [E, H, D] in dst-sorted
    edge order, dattn_l f32 [H, D])."""
    _check(indptr, senders, feat_b, el, er_b, keep, edge_base)
    if feat_b.is_cuda:
        return _launch_bwd(indptr, senders, feat_b.contiguous(), el, er_b,
                           keep, float(inv_keep), float(slope), smax, denom,
                           dout, al_b, edge_base, plan)
    return plain_gat_bwd(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                         slope, smax, denom, dout.float(), al_b, edge_base)


def plain_prep(feat, attn_l, attn_r):
    """Plain version of `gat_prep`: (feat_b, el, er_b, al_b), bf16 features,
    el = <feat_b, bf16 attn_l> in f32, er in f32 rounded once to bf16, bf16
    attn_l."""
    note_plain(feat)
    feat_b = feat.to(torch.bfloat16).contiguous()
    al_b = attn_l.to(torch.bfloat16)
    el = (feat_b.float() * al_b.float()[None]).sum(-1)
    er_b = (feat.float() * attn_r.float()[None]).sum(-1).to(torch.bfloat16)
    return feat_b, el, er_b.contiguous(), al_b


@span("kernel.gat_prep")
def prep(feat, attn_l, attn_r):
    """(feat_b, el, er_b, al_b) of feat [N, H, D] and attn_l / attn_r
    [H, D]: the gat_prep kernel on CUDA tensors, its plain version on the
    CPU."""
    if not feat.is_cuda:
        return plain_prep(feat, attn_l, attn_r)
    feat = feat.float().contiguous()
    n, h, d = feat.shape
    attn_l, attn_r = (a.float().contiguous() for a in (attn_l, attn_r))
    if attn_l.shape != (h, d) or attn_r.shape != (h, d):
        raise TypeError(f"attn_l and attn_r must be [{h}, {d}]")
    feat_b = torch.empty((n, h, d), dtype=torch.bfloat16, device=feat.device)
    el = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    er_b = torch.empty((n, h), dtype=torch.bfloat16, device=feat.device)
    lib = cuda_build.load("gat", _SIGNATURES)
    cuda_build.launch("gat_prep", lib.gat_prep, feat.device, feat.data_ptr(),
                      attn_l.data_ptr(), attn_r.data_ptr(), feat_b.data_ptr(),
                      el.data_ptr(), er_b.data_ptr(), n, h, d)
    counts["gat_prep"] += 1
    return feat_b, el, er_b, attn_l.to(torch.bfloat16)


class _GATAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feat, attn_l, attn_r, g, keep, inv_keep, slope):
        feat_b, el, er_b, al_b = prep(feat, attn_l, attn_r)
        out, smax, denom = gat_fwd(
            g.indptr, g.senders, feat_b, el, er_b, keep, inv_keep, slope,
            plan=spmm_cuda.plan_of(g, "indptr", g.n_nodes, GAT_CHUNK))
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
                                al_b,
                                plan=spmm_cuda.plan_of(g, "indptr", n,
                                                       GAT_CHUNK))
        dfeat_src = spmm_cuda.csr_sum_bf16(
            g.t_indptr, g.t_edges, msg.view(-1, h * d), n,
            spmm_cuda.plan_of(g, "t_indptr", n))
        dfeat = (dfeat_src.view(n, h, d)
                 + der[:, :, None] * attn_r.float()[None])
        dattn_r = torch.einsum("nh,nhd->hd", der, feat.float())
        return (dfeat.to(feat.dtype), dal.to(ctx.attn_l_dtype),
                dattn_r.to(attn_r.dtype), None, None, None, None)


def gat_attention(g, feat, attn_l, attn_r, slope: float = 0.2, keep=None,
                  inv_keep: float = 1.0):
    """The fused attention layer: feat [N, H, D] (= Wh), attn_l/attn_r
    [H, D], keep a mask [E, H], a seed or None, with inv_keep = 1 / keep
    probability. Returns [N, H, D] in feat's dtype."""
    return _GATAttention.apply(feat, attn_l, attn_r, g, keep, float(inv_keep),
                               float(slope))


# ---- the standalone segment softmax ---------------------------------------

class SoftmaxGeometry(NamedTuple):
    g: int   # lanes per edge (the smallest power of two >= H, at most 32)
    p: int   # edge slots per row; 32 // (g * p) rows per warp
    r: int   # scores per lane: rows of at most p * r edges are read once


def softmax_geometry(h: int, n_edges: int, n_rows: int) -> SoftmaxGeometry:
    """edge_softmax_fwd's layout for H = h heads: with SOFTMAX_REGS scores
    per lane, the fewest edge slots per row (the most rows per warp) that
    hold a row of twice the mean in-degree in registers."""
    regs = SOFTMAX_REGS
    g = 1
    while g < h and g < 32:
        g *= 2
    target = 2 * -(-n_edges // max(n_rows, 1))
    p = 1
    while p * regs < target and g * p < 32:
        p *= 2
    return SoftmaxGeometry(g, p, regs)


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


def _launch_softmax_fwd(indptr, scores, n_rows, plan):
    """edge_softmax_fwd over the CSR; on a plan with chunks also the
    chunks' maxima and sums before it, each launch counted."""
    dev, h = scores.device, scores.shape[1]
    alpha = torch.empty_like(scores)
    if plan is None:
        plan = spmm_cuda.hub_plan(indptr, n_rows)
    spmm_cuda.check_plan(plan, n_rows, dev)
    c = plan.n_chunks
    lib = cuda_build.load("gat", _SIGNATURES)
    hub = [None] * 5
    if c:   # each chunk's max, then its sum of exp(s - the row's max)
        pmax = torch.empty((c, h), dtype=torch.float32, device=dev)
        pden = torch.empty((c, h), dtype=torch.float32, device=dev)
        hub = [plan.chunks.data_ptr(), plan.owner.data_ptr(),
               plan.first.data_ptr(), pmax.data_ptr(), pden.data_ptr()]
        for kernel in (0, 1):
            cuda_build.launch("edge_softmax_fwd", lib.edge_softmax_hub_pass,
                              dev, kernel, scores.data_ptr(), *hub, c, h)
            counts["edge_softmax_fwd"] += 1
    geo = softmax_geometry(h, scores.shape[0], n_rows)
    cuda_build.launch("edge_softmax_fwd", lib.edge_softmax_fwd, dev,
                      indptr.data_ptr(), scores.data_ptr(), alpha.data_ptr(),
                      *hub, c, plan.chunk, n_rows, h, geo.p)
    counts["edge_softmax_fwd"] += 1
    return alpha


@span("kernel.edge_softmax_fwd")
def edge_softmax_fwd(indptr, scores, n_rows, plan=None):
    """Segment softmax over the CSC rows: scores f32 [E, H] (E =
    indptr[n_rows], dst-sorted) -> alpha f32 [E, H]. `plan` is the CSR's
    hub plan (`spmm_cuda.plan_of`; built here when None, two host syncs):
    on a plan with chunks the split rows' chunk maxima and sums go first,
    three launches in all."""
    _check_edge_rows(indptr, n_rows, scores)
    if scores.is_cuda:
        return _launch_softmax_fwd(indptr, scores.contiguous(), n_rows, plan)
    return plain_edge_softmax_fwd(indptr, scores, n_rows)


def _launch_softmax_bwd(indptr, alpha, dalpha, n_rows, plan):
    """edge_softmax_bwd over the CSR; on a plan with chunks also the
    chunks' parts of t before it, each launch counted."""
    dev, h = alpha.device, alpha.shape[1]
    ds = torch.empty_like(alpha)
    if plan is None:
        plan = spmm_cuda.hub_plan(indptr, n_rows)
    spmm_cuda.check_plan(plan, n_rows, dev)
    c = plan.n_chunks
    lib = cuda_build.load("gat", _SIGNATURES)
    hub = [None] * 4
    if c:   # each chunk's part of its row's t
        pt = torch.empty((c, h), dtype=torch.float32, device=dev)
        hub = [plan.chunks.data_ptr(), plan.owner.data_ptr(),
               plan.first.data_ptr(), pt.data_ptr()]
        cuda_build.launch("edge_softmax_bwd", lib.edge_softmax_bwd_hub_t,
                          dev, alpha.data_ptr(), dalpha.data_ptr(), hub[0],
                          hub[3], c, h)
        counts["edge_softmax_bwd"] += 1
    cuda_build.launch("edge_softmax_bwd", lib.edge_softmax_bwd, dev,
                      indptr.data_ptr(), alpha.data_ptr(), dalpha.data_ptr(),
                      ds.data_ptr(), *hub, c, plan.chunk, n_rows, h)
    counts["edge_softmax_bwd"] += 1
    return ds


@span("kernel.edge_softmax_bwd")
def edge_softmax_bwd(indptr, alpha, dalpha, n_rows, plan=None):
    """Its VJP: alpha and dalpha f32 [E, H] -> ds f32 [E, H]. `plan` is
    the CSR's hub plan, the forward's (`spmm_cuda.plan_of`; built here when
    None, two host syncs): on a plan with chunks the split rows' parts of
    t go first, two launches in all."""
    _check_edge_rows(indptr, n_rows, alpha, dalpha)
    if alpha.is_cuda:
        return _launch_softmax_bwd(indptr, alpha.contiguous(),
                                   dalpha.contiguous(), n_rows, plan)
    return plain_edge_softmax_bwd(indptr, alpha, dalpha, n_rows)


class _EdgeSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, scores, indptr, n_rows, plan):
        alpha = edge_softmax_fwd(indptr, scores, n_rows, plan)
        ctx.save_for_backward(alpha, indptr)
        ctx.n_rows, ctx.plan = n_rows, plan
        return alpha

    @staticmethod
    def backward(ctx, dalpha):
        alpha, indptr = ctx.saved_tensors
        return edge_softmax_bwd(indptr, alpha, dalpha.float(), ctx.n_rows,
                                ctx.plan), None, None, None


def csr_softmax(indptr, scores, n_rows, plan=None):
    """Softmax of scores [E] or [E, H] over the segments of the CSR
    indptr's n_rows rows (E = indptr[n_rows]), in the same shape and
    dtype; the kernels run in f32. `plan`: the CSR's hub plan, as
    `edge_softmax_fwd` takes it (pass the kept one: `spmm_cuda.plan_of`)."""
    if scores.dim() not in (1, 2):
        raise ValueError(f"the softmax takes scores [E] or [E, H], got "
                         f"{tuple(scores.shape)}")
    s2 = scores[:, None] if scores.dim() == 1 else scores
    alpha = _EdgeSoftmax.apply(s2.float(), indptr, n_rows, plan).to(
        scores.dtype)
    return alpha[:, 0] if scores.dim() == 1 else alpha


def edge_softmax(g, scores):
    """Softmax of scores [E] or [E, H] (dst-sorted edge order) over each
    dst's in-edges, in the same shape and dtype; the kernels run in f32
    with g's kept hub plan."""
    if scores.dim() not in (1, 2) or scores.shape[0] != g.n_edges:
        raise ValueError(f"edge_softmax takes scores [{g.n_edges}] or "
                         f"[{g.n_edges}, H], got {tuple(scores.shape)}")
    return csr_softmax(g.indptr, scores, g.n_nodes,
                       spmm_cuda.plan_of(g, "indptr", g.n_nodes))
