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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.ops import refops, spmm_cuda


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

    is_halo = True

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows

    @property
    def n_recv(self) -> int:
        return sum(self.recv_splits)

    def to(self, device) -> "HaloGraph":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _csr(rows_of_edge: np.ndarray, cols: np.ndarray, n_rows: int):
    """(indptr, indices) int32 of edges (rows_of_edge, cols), stable by
    row."""
    order = np.argsort(rows_of_edge, kind="stable")
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows_of_edge, minlength=n_rows), out=indptr[1:])
    return (torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(cols[order].astype(np.int32)))


def build_halo_graph(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                     n_shards: int) -> list:
    """The `n_shards` HaloGraph shards (CPU tensors) of the graph
    (src, dst) of n_nodes nodes. One unique over the halo edges' (source
    shard, destination shard, source) keys gives every send list sorted
    and each halo edge's place in its receive buffer."""
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
            n_nodes=n, n_shards=p_count, rank=p, rows=rows))
    return shards


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


def csr_part(kernel: bool, indptr, indices, x: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """One partial sum: the exact CSR SpMM kernel's (bf16 messages, f32
    sums), or the f32 plain sum, in f32 (no call for no rows)."""
    if n_rows == 0:
        return x.new_zeros((0, x.shape[1]), dtype=torch.float32)
    if kernel:
        return spmm_cuda.csr_sum_bf16(indptr, indices,
                                      spmm_cuda.to_message(x.contiguous()),
                                      n_rows)
    return refops.csr_sum_f32(indptr, indices, x.float().contiguous(), n_rows)


class _HaloCopyUSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hg, kernel):
        ctx.hg, ctx.kernel = hg, kernel
        part_l = csr_part(kernel, hg.indptr, hg.indices, x, hg.rows)
        recv = _mesh.all_to_all(x.index_select(0, hg.send_idx),
                                hg.send_splits, hg.recv_splits)
        part_h = csr_part(kernel, hg.halo_indptr, hg.halo_indices, recv,
                          hg.rows)
        return (part_l + part_h).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        hg, kernel = ctx.hg, ctx.kernel
        dx = csr_part(kernel, hg.t_indptr, hg.t_indices, dout, hg.rows)
        drecv = csr_part(kernel, hg.halo_t_indptr, hg.halo_t_indices, dout,
                         hg.n_recv)
        dsend = _mesh.all_to_all(drecv, hg.recv_splits, hg.send_splits)
        dx.index_add_(0, hg.send_idx, dsend)
        return dx.to(dout.dtype), None, None


def halo_copy_u_sum(hg: HaloGraph, x: torch.Tensor,
                    kernel: bool = True) -> torch.Tensor:
    """out[v] = sum over in-edges of v of x[src] for this shard's rows v:
    x [rows, F] is this rank's row block; every rank calls it together.
    `kernel`: the exact SpMM kernel tier (else the f32 plain sums)."""
    if x.dim() != 2 or x.shape[0] != hg.rows:
        raise ValueError(f"halo_copy_u_sum takes this shard's [{hg.rows}, F] "
                         f"rows, got {tuple(x.shape)}")
    return _HaloCopyUSum.apply(x, hg, kernel)
