"""The device-side graph: dst-sorted COO plus its CSC and transposed CSR.

Counterpart of `glnn_tpu/graph/container.py`. Edges are sorted by
destination (stable), so `indptr` is the CSC row pointer that the CUDA
SpMM walks directly; the transposed, src-sorted CSR (`t_indptr`,
`t_receivers`) carries the kernel's backward (dX = A^T dH), and `t_edges`
lets the same kernel reduce per-edge messages (kept in dst-sorted edge
order) over sources, as the GAT backward does. The TPU plans
(SpmmPlan, AttentionPlan) are TPU geometry and have no counterpart here.
The aligned window table (`Graph.with_window_table`, JAX's `win1` [N+1, 64]
of each node's first 64 in-neighbours) is TPU gather geometry too: on the
GPU one index gather of `senders[indptr[v] + lane]` reads the same id. What
the table changes is the window sampler's fold rule for nodes of more than
64 in-edges (`sampling/sampler.py`), so the port keeps only a mark,
`win1`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from glnn_tpu_torch import native


@dataclasses.dataclass(frozen=True)
class Graph:
    """Attributes:
      senders:     int32[E]   source node per edge, dst-sorted order.
      receivers:   int32[E]   destination node per edge, nondecreasing.
      indptr:      int32[N+2] CSC row pointer (with the ghost row N, as in
                              the JAX container); in-edges of v are
                              indptr[v]:indptr[v+1].
      in_degrees:  float32[N]
      out_degrees: float32[N]
      t_indptr:    int32[N+1] CSR row pointer over sources.
      t_receivers: int32[E]   destination per edge, src-sorted order.
      t_edges:     int32[E]   for each src-sorted slot, that edge's position
                              in the dst-sorted edge list.
      n_nodes, n_edges: ints.
      win1:        the graph carries the aligned window table
                   (`with_window_table`). It selects the window sampler's
                   1-row fold rule.
      cache:       what a kernel derives from the graph once and keeps
                   (the f32 SpMM's hub-row plan); a moved or replaced
                   Graph starts with an empty one.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    indptr: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    t_indptr: torch.Tensor
    t_receivers: torch.Tensor
    t_edges: torch.Tensor
    n_nodes: int
    n_edges: int
    win1: bool = False
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    # the whole graph: its edges are the global edges from the first, so
    # the per-edge random draws (APPNP's edge drop, GAT's Philox bits) read
    # these as a halo shard's slice of the global order does
    edge_base = 0

    @property
    def n_edges_global(self) -> int:
        return self.n_edges

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def to(self, device) -> "Graph":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)

    def with_window_table(self) -> "Graph":
        """Mark the graph as carrying the aligned 64-wide window table
        (`glnn_tpu/graph/container.py:112 with_window_table`): the window
        sampler then folds a node's offsets onto its first 64 in-edges,
        and is equal to Floyd for degrees <= 64."""
        return dataclasses.replace(self, win1=True)


def _csr(keys: np.ndarray, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort order by `keys` (`native.sort_edges`, the counting sort
    that JAX's `_sort_by_dst` calls) and the row pointer it implies."""
    order = native.sort_edges(keys, n_rows)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_rows), out=indptr[1:])
    return order, indptr


def build_graph(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> Graph:
    """A dst-sorted `Graph` on the CPU from host COO arrays."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    n_edges = int(src.shape[0])
    if n_edges >= 2 ** 31 or n_nodes >= 2 ** 31:
        raise ValueError("the int32 CSR holds fewer than 2**31 edges and nodes")
    if n_edges and (min(src.min(), dst.min()) < 0
                    or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"edge endpoints must lie in [0, {n_nodes})")

    order, indptr = _csr(dst, n_nodes + 1)      # ghost row N stays empty
    src_s, dst_s = src[order], dst[order]
    t_order, t_indptr = _csr(src_s, n_nodes)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    return Graph(
        senders=i32(src_s),
        receivers=i32(dst_s),
        indptr=i32(indptr),
        in_degrees=torch.from_numpy(
            np.bincount(dst, minlength=n_nodes).astype(np.float32)),
        out_degrees=torch.from_numpy(
            np.bincount(src, minlength=n_nodes).astype(np.float32)),
        t_indptr=i32(t_indptr),
        t_receivers=i32(dst_s[t_order]),
        t_edges=i32(t_order),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
    )


def graph_from_csr(indptr: np.ndarray, indices: np.ndarray,
                   n_nodes: int) -> Graph:
    """A `Graph` from host CSR (row = src, indices = its dst neighbours),
    as `glnn_tpu/graph/container.py:260 graph_from_csr` builds it. JAX's
    `**kw` (its attention and SpMM plans) has no counterpart: the port
    builds no plans."""
    indptr = np.asarray(indptr, np.int64)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), np.diff(indptr))
    return build_graph(src, np.asarray(indices, np.int64), n_nodes)
