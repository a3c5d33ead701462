"""Halo-exchange sharded aggregation (`glnn_tpu/distributed/halo.py`).

Nodes are split into P contiguous blocks of rows = ceil(n / P) (the last
block's rows past n are ghosts: no edges, zero features), shard p holds
rows p*rows .. (p+1)*rows - 1, and every edge is owned by its destination's
shard. Shard p then sums its rows' in-edges in two parts:

    partial_local = A_local x_p           (sources on p, no communication)
    recv          = all_to_all(x_p[send]) (the halo: source rows of other
                                           shards, each sent once)
    partial_halo  = A_halo recv
    out_p         = partial_local + partial_halo

The host side (`build_halo_graph`) is JAX's `build_halo_graph` without
its TPU slot geometry (the SpmmPlans, attention plans and ghost slots):
each shard gets a CSR of its local edges (rows over its own rows), a CSR
of its halo edges (rows over the receive buffer), the transposes of both
for the backward, its send lists (rank q's list for p: the sorted unique
rows of q that p's edges read, JAX's `send_idx[q, p]`), and the exact send
and receive counts, so the uneven all_to_all moves no padding. The degrees
are the global in- and out-degrees of the shard's rows, so the layers'
degree norms read the whole graph's.

The device side (`halo_copy_u_sum`) runs both partials on the exact CSR
SpMM kernel (`spmm_cuda.csr_sum_bf16`: bf16 messages, f32 sums; JAX's
`spmm_rect` under per-shard plans) for a CUDA tensor under the kernel
tier, and the f32 plain sums otherwise (the CPU: JAX's XLA segment sums).
Its backward runs the same kernel over the transposed local CSR and the
transposed halo CSR, sends the halo gradient back with the reverse
exchange and adds it at the send rows. The exchange moves rows in x's
dtype, as JAX's all_to_all does.

The per-edge ops (GAT's scores, softmax and weighted sum, APPNP's
weighted hops) need all of a row's in-edges together, so a shard built
with `combined=True` also holds one CSR of all its edges (`c_*`): rows
the shard's rows, edges in the single-device `Graph`'s order (stable by
dst), sources indices into [own rows; receive buffer], and its transpose
over those rows + n_recv sources. The shard's edges are then one
contiguous slice of the global dst-sorted edge order, from `edge_base`:
a per-edge tensor drawn in global order (APPNP's masks, the GAT
kernels' Philox bits) is sliced, not gathered. JAX keeps per-edge
tensors in its shard layout [local slots; halo slots] with ghosts
(`glnn_tpu/distributed/halo.py:96-104`); the port's are in this combined
order. Every op that reads source rows gets them through `source_table`
([x; the exchanged send rows]), whose backward sends the receive rows'
gradient home and adds it at the send rows.

* `halo_u_add_v`, `halo_edge_softmax` (JAX `:391`, `:478`): gathers over
  the combined CSR; the softmax runs the segment softmax kernels
  (`gat_cuda.csr_softmax`, forward and backward on the CSR's kept plan)
  under the kernel tier, the f32 plain softmax otherwise.
* `halo_u_mul_e_sum` (JAX `:604`, `_planned_halo_wsum` :523-600): the
  weighted SpMM kernel over the combined CSR on [x; recv], its dX over
  the transpose (weights through `c_t_edges`), dW in f32 (as
  `spmm_cuda.csr_u_mul_e_sum`); the f32 plain sums otherwise. One launch
  each way, where two partials (local rows, receive buffer) would take
  two: the copy into [x; recv] moves (rows + n_recv) x F values once.
* `halo_gat_attention` (JAX `:748` with `_fused_gat`, :776): `gat_prep`
  on the shard's rows; one exchange of the send rows' bf16 features
  beside their el (its f32 bits as two bf16 values); `gat_fwd` over the
  combined CSR with `edge_base` and the CSR's hub plan at
  `gat_cuda.GAT_CHUNK`. Its backward: `gat_bwd` on that plan, the exact SpMM
  source reduce over the combined transpose (`c_t_edges`, rows + n_recv
  rows), the receive rows' part of dfeat sent home; dattn_l and dattn_r
  are this shard's, summed over the ranks by `mesh.all_reduce_grads`.

A HaloGraph carries these as methods named after the ops (`copy_u_sum`,
`u_add_v`, `edge_softmax`, `u_mul_e_sum`, `gat_attention`), which the op
surface calls for a shard after it has picked the tier, so that the ops
and the models import nothing of this package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from glnn_tpu_torch import native
from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.ops import cuda_build, gat_cuda, refops, spmm_cuda


@dataclasses.dataclass(frozen=True)
class HaloGraph:
    """One shard of a halo-sharded graph.

      indptr, indices:       int32 CSR of the local edges, by local dst
                             row; indices are local source rows.
      t_indptr, t_indices:   its transpose, by local source row.
      halo_indptr, halo_indices: int32 CSR of the halo edges, by local dst
                             row; indices are rows of the receive buffer.
      halo_t_indptr, halo_t_indices: its transpose, by receive row.
      send_idx:              int64 local rows to send, rank by rank.
      send_splits, recv_splits: rows sent to / received from each rank.
      in_degrees, out_degrees: float32[rows], global degrees of the rows.
    With `combined=True` (None otherwise):
      c_indptr, c_indices, c_dst: int32 CSR of all the shard's edges, by
                             local dst row, in global dst-sorted order;
                             indices are rows of [own rows; receive
                             buffer], c_dst each edge's local dst row.
      c_t_indptr, c_t_dst, c_t_edges: its transpose over rows + n_recv
                             source rows: each slot's dst row and edge.
      edge_base:             global dst-sorted id of the shard's first edge.
      n_edges_global:        the whole graph's edge count.
      cache:                 the hub plans of its CSRs
                             (`spmm_cuda.plan_of`), built once; a moved or
                             replaced shard starts with an empty one.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    t_indptr: torch.Tensor
    t_indices: torch.Tensor
    halo_indptr: torch.Tensor
    halo_indices: torch.Tensor
    halo_t_indptr: torch.Tensor
    halo_t_indices: torch.Tensor
    send_idx: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    send_splits: tuple
    recv_splits: tuple
    n_nodes: int
    n_shards: int
    rank: int
    rows: int
    c_indptr: torch.Tensor | None = None
    c_indices: torch.Tensor | None = None
    c_dst: torch.Tensor | None = None
    c_t_indptr: torch.Tensor | None = None
    c_t_dst: torch.Tensor | None = None
    c_t_edges: torch.Tensor | None = None
    edge_base: int = 0
    n_edges_global: int = 0
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    # the shard's op forms: the op surface (ops/__init__.py) hands a shard
    # to these, `kernel` its tier choice
    def copy_u_sum(self, x, kernel):
        return halo_copy_u_sum(self, x, kernel)

    def u_add_v(self, a_u, a_v):
        return halo_u_add_v(self, a_u, a_v)

    def edge_softmax(self, scores, kernel):
        return halo_edge_softmax(self, scores, kernel)

    def u_mul_e_sum(self, x, e, kernel):
        return halo_u_mul_e_sum(self, x, e, kernel)

    def gat_attention(self, feat, attn_l, attn_r, slope, seed, inv_keep):
        return halo_gat_attention(self, feat, attn_l, attn_r, slope, seed,
                                  inv_keep)

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows

    @property
    def n_recv(self) -> int:
        return sum(self.recv_splits)

    @property
    def n_edges(self) -> int:
        """The shard's edges (those of its rows), in the combined CSR."""
        return _combined(self).c_indices.shape[0]

    def combined_csr(self) -> spmm_cuda.WeightedCSR:
        """The combined CSR as the weighted sum walks it."""
        c = _combined(self)
        n_src = c.rows + c.n_recv
        return spmm_cuda.WeightedCSR(
            c.c_indptr, c.c_indices, c.c_dst, c.c_t_indptr, c.c_t_dst,
            c.c_t_edges, c.rows, n_src,
            spmm_cuda.plan_of(c, "c_indptr", c.rows),
            spmm_cuda.plan_of(c, "c_t_indptr", n_src))

    def to(self, device) -> "HaloGraph":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _combined(hg: HaloGraph) -> HaloGraph:
    if hg.c_indptr is None:
        raise ValueError("the per-edge halo ops need the shard's combined "
                         "CSR: build_halo_graph(..., combined=True)")
    return hg


def _csr(rows_of_edge: np.ndarray, cols: np.ndarray, n_rows: int):
    """(indptr, indices) int32 of edges (rows_of_edge, cols), stable by
    row."""
    order = native.sort_edges(rows_of_edge, n_rows)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows_of_edge, minlength=n_rows), out=indptr[1:])
    return (torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(cols[order].astype(np.int32)))


def build_halo_graph(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                     n_shards: int, combined: bool = False) -> list:
    """The `n_shards` HaloGraph shards (CPU tensors) of the graph
    (src, dst) of n_nodes nodes, with each shard's combined CSR when
    `combined` (the GAT and APPNP teachers). One unique over the halo
    edges' (source shard, destination shard, source) keys gives every
    send list sorted and each halo edge's place in its receive buffer."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n, p_count = int(n_nodes), int(n_shards)
    rows = -(-n // p_count)
    shard_src, shard_dst = src // rows, dst // rows
    is_local = shard_src == shard_dst

    hidx = np.nonzero(~is_local)[0]
    hq, hp, hs = shard_src[hidx], shard_dst[hidx], src[hidx]
    key = (hq * p_count + hp) * n + hs
    uk, inv = np.unique(key, return_inverse=True)
    g_of = uk // n                                # q * P + p per send row
    counts = np.bincount(g_of, minlength=p_count * p_count).reshape(
        p_count, p_count)                         # [q, p]
    gstart = np.concatenate([[0], np.cumsum(counts.reshape(-1))])
    rank_in_list = np.arange(len(uk)) - gstart[g_of]
    # receive buffer of p: the lists (q, p) in q order
    recv_off = np.zeros((p_count + 1, p_count), np.int64)   # [q, p]
    np.cumsum(counts, axis=0, out=recv_off[1:])
    recv_pos = recv_off[g_of // p_count, g_of % p_count] + rank_in_list
    halo_pos = recv_pos[np.asarray(inv).reshape(-1)]

    n_pad = p_count * rows
    ind = np.bincount(dst, minlength=n_pad).astype(np.float32)
    outd = np.bincount(src, minlength=n_pad).astype(np.float32)
    uk_src = uk % n
    if combined:
        # every edge's source in [own rows; receive buffer] of its dst's
        # shard, in the global dst-sorted (stable) order
        csrc = src - shard_dst * rows
        csrc[hidx] = rows + halo_pos
        order = native.sort_edges(dst, n)
        csrc, cdst = csrc[order], dst[order]
        g_indptr = np.zeros(n_pad + 1, np.int64)
        np.cumsum(ind.astype(np.int64), out=g_indptr[1:])

    shards = []
    for p in range(p_count):
        base = p * rows
        lmask = is_local & (shard_dst == p)
        lsrc, ldst = src[lmask] - base, dst[lmask] - base
        hmask = hp == p
        hdst, hpos = dst[hidx][hmask] - base, halo_pos[hmask]
        n_recv = int(counts[:, p].sum())
        send = uk_src[gstart[p * p_count]:gstart[(p + 1) * p_count]] - base
        indptr, indices = _csr(ldst, lsrc, rows)
        t_indptr, t_indices = _csr(lsrc, ldst, rows)
        h_indptr, h_indices = _csr(hdst, hpos, rows)
        ht_indptr, ht_indices = _csr(hpos, hdst, n_recv)
        extra = {}
        if combined:
            lo = int(g_indptr[base])
            c_src = csrc[lo:int(g_indptr[base + rows])]
            c_dst = cdst[lo:lo + c_src.shape[0]] - base
            t_order = native.sort_edges(c_src, rows + n_recv)
            t_indptr_c = np.zeros(rows + n_recv + 1, np.int64)
            np.cumsum(np.bincount(c_src, minlength=rows + n_recv),
                      out=t_indptr_c[1:])
            extra = dict(
                c_indptr=_i32(g_indptr[base:base + rows + 1] - lo),
                c_indices=_i32(c_src), c_dst=_i32(c_dst),
                c_t_indptr=_i32(t_indptr_c), c_t_dst=_i32(c_dst[t_order]),
                c_t_edges=_i32(t_order), edge_base=lo,
                n_edges_global=int(src.shape[0]))
        shards.append(HaloGraph(
            indptr=indptr, indices=indices, t_indptr=t_indptr,
            t_indices=t_indices, halo_indptr=h_indptr,
            halo_indices=h_indices, halo_t_indptr=ht_indptr,
            halo_t_indices=ht_indices,
            send_idx=torch.from_numpy(np.ascontiguousarray(send)),
            in_degrees=torch.from_numpy(ind[base:base + rows].copy()),
            out_degrees=torch.from_numpy(outd[base:base + rows].copy()),
            send_splits=tuple(int(c) for c in counts[p]),
            recv_splits=tuple(int(c) for c in counts[:, p]),
            n_nodes=n, n_shards=p_count, rank=p, rows=rows, **extra))
    return shards


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def halo_fraction(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                  n_shards: int) -> float:
    """Share of the edges whose source lies on another shard."""
    rows = -(-int(n_nodes) // int(n_shards))
    return float((np.asarray(src) // rows != np.asarray(dst) // rows).mean())


def shard_rows(x: np.ndarray, n_shards: int, rank: int) -> np.ndarray:
    """Rank `rank`'s block of ceil(n / P) rows of x, ghost rows zero."""
    x = np.asarray(x)
    rows = -(-x.shape[0] // n_shards)
    block = x[rank * rows:(rank + 1) * rows]
    pad = np.zeros((rows - block.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([block, pad])


def csr_part(kernel: bool, hg: HaloGraph, csr: str, x: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """One partial sum over the shard's CSR named `csr` ("indptr",
    "halo_t_indptr", ...; its indices beside it): the exact CSR SpMM
    kernel's (bf16 messages, f32 sums; the CSR's hub plan kept on the
    shard), or the f32 plain sum, in f32 (no call for no rows)."""
    if n_rows == 0:
        return x.new_zeros((0, x.shape[1]), dtype=torch.float32)
    indptr = getattr(hg, csr)
    indices = getattr(hg, csr.replace("indptr", "indices"))
    if kernel:
        return spmm_cuda.csr_sum_bf16(indptr, indices,
                                      spmm_cuda.to_message(x.contiguous()),
                                      n_rows, spmm_cuda.plan_of(hg, csr,
                                                                n_rows))
    return refops.csr_sum_f32(indptr, indices, x.float().contiguous(), n_rows)


def _add_home(hg: HaloGraph, dx: torch.Tensor,
              drecv: torch.Tensor) -> torch.Tensor:
    """dx [rows, ...] (in place) plus the receive rows' gradient drecv sent
    home by the reverse exchange and added at the send rows."""
    return dx.index_add_(0, hg.send_idx, _mesh.all_to_all(
        drecv, hg.recv_splits, hg.send_splits))


class _HaloCopyUSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hg, kernel):
        ctx.hg, ctx.kernel = hg, kernel
        part_l = csr_part(kernel, hg, "indptr", x, hg.rows)
        recv = _mesh.all_to_all(x.index_select(0, hg.send_idx),
                                hg.send_splits, hg.recv_splits)
        part_h = csr_part(kernel, hg, "halo_indptr", recv, hg.rows)
        return (part_l + part_h).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        hg, kernel = ctx.hg, ctx.kernel
        dx = csr_part(kernel, hg, "t_indptr", dout, hg.rows)
        drecv = csr_part(kernel, hg, "halo_t_indptr", dout, hg.n_recv)
        return _add_home(hg, dx, drecv).to(dout.dtype), None, None


def halo_copy_u_sum(hg: HaloGraph, x: torch.Tensor,
                    kernel: bool = True) -> torch.Tensor:
    """out[v] = sum over in-edges of v of x[src] for this shard's rows v:
    x [rows, F] is this rank's row block; every rank calls it together.
    `kernel`: the exact SpMM kernel tier (else the f32 plain sums)."""
    if x.dim() != 2 or x.shape[0] != hg.rows:
        raise ValueError(f"halo_copy_u_sum takes this shard's [{hg.rows}, F] "
                         f"rows, got {tuple(x.shape)}")
    return _HaloCopyUSum.apply(x, hg, kernel)


# ---- the per-edge ops over the combined CSR --------------------------------

class _Exchange(torch.autograd.Function):
    """The receive buffer: every rank's send rows of x for this rank, rank
    by rank; the backward sends its gradient home and adds it at the send
    rows."""

    @staticmethod
    def forward(ctx, x, hg):
        ctx.hg, ctx.rows = hg, x.shape[0]
        return _mesh.all_to_all(x.index_select(0, hg.send_idx),
                                hg.send_splits, hg.recv_splits)

    @staticmethod
    def backward(ctx, drecv):
        dx = drecv.new_zeros((ctx.rows,) + tuple(drecv.shape[1:]))
        return _add_home(ctx.hg, dx, drecv), None


def source_table(hg: HaloGraph, x: torch.Tensor) -> torch.Tensor:
    """[x; receive buffer]: the source rows the combined CSR indexes, in
    x's dtype (differentiable; every rank calls it together)."""
    return torch.cat([x, _Exchange.apply(x, hg)])


def _check_rows(hg: HaloGraph, op: str, *xs) -> None:
    for x in xs:
        if x.shape[0] != hg.rows:
            raise ValueError(f"{op} takes this shard's {hg.rows} rows, got "
                             f"{tuple(x.shape)}")


def _check_edges(hg: HaloGraph, op: str, e: torch.Tensor) -> None:
    if e.shape[0] != hg.n_edges:
        raise ValueError(f"{op} takes this shard's {hg.n_edges} edges "
                         f"(combined CSR order), got {tuple(e.shape)}")


def halo_u_add_v(hg: HaloGraph, a_u: torch.Tensor,
                 a_v: torch.Tensor) -> torch.Tensor:
    """Per-edge a_u[src] + a_v[dst] over this shard's edges, in the
    combined CSR's order: a_u, a_v [rows, ...] this rank's rows."""
    _check_rows(_combined(hg), "halo_u_add_v", a_u, a_v)
    return (source_table(hg, a_u).index_select(0, hg.c_indices)
            + a_v.index_select(0, hg.c_dst))


def halo_edge_softmax(hg: HaloGraph, scores: torch.Tensor,
                      kernel: bool = True) -> torch.Tensor:
    """Softmax over each of this shard's rows' in-edges of scores [E_p] or
    [E_p, H] (combined CSR order): the segment softmax kernels under the
    kernel tier (their plain versions on the CPU), else the f32 plain
    softmax."""
    _check_edges(_combined(hg), "halo_edge_softmax", scores)
    if kernel:
        return gat_cuda.csr_softmax(hg.c_indptr, scores, hg.rows,
                                    spmm_cuda.plan_of(hg, "c_indptr", hg.rows))
    cuda_build.note_plain(scores)
    return refops.segment_softmax(hg.c_dst, hg.rows, scores)


def halo_u_mul_e_sum(hg: HaloGraph, x: torch.Tensor, w: torch.Tensor,
                     kernel: bool = True) -> torch.Tensor:
    """h_v = sum over v's in-edges of w_e x[src] for this shard's rows v:
    x [rows, F] with w [E_p], or x [rows, H, D] with w [E_p, H]. The
    weighted SpMM kernel under the kernel tier (bf16 products, f32 sums;
    its plain version on the CPU), else f32 plain sums."""
    _check_rows(_combined(hg), "halo_u_mul_e_sum", x)
    _check_edges(hg, "halo_u_mul_e_sum", w)
    src = source_table(hg, x)
    if kernel:
        return spmm_cuda.csr_u_mul_e_sum(hg.combined_csr(), src, w)
    cuda_build.note_plain(x)
    msgs = src.index_select(0, hg.c_indices)
    while w.dim() < msgs.dim():
        w = w[..., None]
    return msgs.new_zeros((hg.rows,) + tuple(msgs.shape[1:])).index_add_(
        0, hg.c_dst, msgs * w)


class _HaloGATAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feat, attn_l, attn_r, hg, keep, inv_keep, slope):
        rows, h, d = feat.shape
        feat_b, el, er_b, al_b = gat_cuda.prep(feat, attn_l, attn_r)
        # the send rows' bf16 features and el (its f32 bits as two bf16
        # values) in one exchange
        packed = torch.cat([feat_b.view(rows, h * d),
                            el.view(torch.bfloat16)], 1)
        recv = _mesh.all_to_all(packed.index_select(0, hg.send_idx),
                                hg.send_splits, hg.recv_splits)
        src_b = torch.cat([feat_b.view(rows, h * d),
                           recv[:, :h * d]]).view(-1, h, d)
        src_el = torch.cat([el, recv[:, h * d:].contiguous().view(
            torch.float32)])
        out, smax, denom = gat_cuda.gat_fwd(
            hg.c_indptr, hg.c_indices, src_b, src_el, er_b, keep, inv_keep,
            slope, hg.edge_base,
            spmm_cuda.plan_of(hg, "c_indptr", rows, gat_cuda.GAT_CHUNK))
        ctx.save_for_backward(feat, attn_r, src_b, src_el, er_b, al_b, keep,
                              smax, denom)
        ctx.hg, ctx.inv_keep, ctx.slope = hg, inv_keep, slope
        ctx.attn_l_dtype = attn_l.dtype
        return out.to(feat.dtype)

    @staticmethod
    def backward(ctx, dout):
        feat, attn_r, src_b, src_el, er_b, al_b, keep, smax, denom = \
            ctx.saved_tensors
        hg = ctx.hg
        rows, h, d = feat.shape
        der, msg, dal = gat_cuda.gat_bwd(
            hg.c_indptr, hg.c_indices, src_b, src_el, er_b, keep,
            ctx.inv_keep, ctx.slope, smax, denom, dout, al_b, hg.edge_base,
            spmm_cuda.plan_of(hg, "c_indptr", rows, gat_cuda.GAT_CHUNK))
        n_src = rows + hg.n_recv
        dsrc = spmm_cuda.csr_sum_bf16(hg.c_t_indptr, hg.c_t_edges,
                                      msg.view(-1, h * d), n_src,
                                      spmm_cuda.plan_of(hg, "c_t_indptr",
                                                        n_src))
        dfeat = _add_home(hg, dsrc[:rows], dsrc[rows:]).view(rows, h, d)
        dfeat = dfeat + der[:, :, None] * attn_r.float()[None]
        dattn_r = torch.einsum("nh,nhd->hd", der, feat.float())
        return (dfeat.to(feat.dtype), dal.to(ctx.attn_l_dtype),
                dattn_r.to(attn_r.dtype), None, None, None, None)


def halo_gat_attention(hg: HaloGraph, feat: torch.Tensor,
                       attn_l: torch.Tensor, attn_r: torch.Tensor,
                       slope: float = 0.2, keep=None,
                       inv_keep: float = 1.0) -> torch.Tensor:
    """The fused GAT attention layer over this shard's rows: feat
    [rows, H, D] (= Wh), attn_l / attn_r [H, D] (replicated), keep None or
    a Philox seed (int64 [1], the same on every rank), inv_keep = 1 / keep
    probability. Returns [rows, H, D] in feat's dtype: on CUDA tensors the
    kernels, on the CPU their plain versions, with the single-device keep
    bits of the same global edges."""
    _check_rows(_combined(hg), "halo_gat_attention", feat)
    if keep is not None and not gat_cuda._is_seed(keep):
        raise TypeError("halo_gat_attention takes a Philox seed, not a mask")
    return _HaloGATAttention.apply(feat, attn_l, attn_r, hg, keep,
                                   float(inv_keep), float(slope))
