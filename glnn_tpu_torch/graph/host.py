"""Host-side graph: COO edges, node features and the edge surgery that
ingest needs (`glnn_tpu/graph/host.py`).

`to_bidirected`, `induced_subgraph`, `coo_to_csr` and
`connected_components` are the port's host-graph library
(`glnn_tpu_torch.native`: the C++ of `csrc/graphops.cpp`, or its numpy and
scipy tier where no g++ is found), as `glnn_tpu`'s HostGraph routes them
through `glnn_tpu.native`; both tiers give JAX's arrays (to_bidirected
sorts by the key src * n + dst; induced_subgraph keeps the edges' order;
coo_to_csr is a stable sort by row; components are numbered by their first
node).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from glnn_tpu_torch.graph.container import Graph, build_graph
from glnn_tpu_torch.native import (
    connected_components,
    coo_to_csr,
    induced_subgraph,
    to_bidirected,
)


class HostGraph:
    """COO edges plus `ndata` node features (the reference's `g`)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.n_nodes = int(n_nodes)
        self.ndata: dict[str, np.ndarray] = {}

    def num_nodes(self) -> int:
        return self.n_nodes

    def number_of_nodes(self) -> int:
        return self.n_nodes

    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def number_of_edges(self) -> int:
        return self.num_edges()

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_nodes)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_nodes)

    def _with_edges(self, src, dst) -> "HostGraph":
        g = HostGraph(src, dst, self.n_nodes)
        g.ndata = dict(self.ndata)
        return g

    def add_reverse_edges(self) -> "HostGraph":
        """Append a reversed copy of every edge, duplicates kept (ogbn-arxiv's
        `g.add_edges(dsts, srcs)`)."""
        return self._with_edges(np.concatenate([self.src, self.dst]),
                                np.concatenate([self.dst, self.src]))

    def to_bidirected(self) -> "HostGraph":
        return self._with_edges(*to_bidirected(self.src, self.dst,
                                               self.n_nodes))

    def remove_self_loop(self) -> "HostGraph":
        keep = self.src != self.dst
        return self._with_edges(self.src[keep], self.dst[keep])

    def add_self_loop(self) -> "HostGraph":
        loops = np.arange(self.n_nodes, dtype=np.int64)
        return self._with_edges(np.concatenate([self.src, loops]),
                                np.concatenate([self.dst, loops]))

    def subgraph(self, idx) -> "HostGraph":
        """Node-induced subgraph, relabelled so that new id i == idx[i],
        with `ndata` sliced to idx."""
        idx = np.asarray(idx, np.int64)
        g = HostGraph(*induced_subgraph(self.src, self.dst, self.n_nodes, idx),
                      idx.shape[0])
        g.ndata = {k: v[idx] for k, v in self.ndata.items()}
        return g

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Out-adjacency (indptr, indices): the nodes reachable from v."""
        return coo_to_csr(self.src, self.dst, self.n_nodes)

    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        """In-adjacency (indptr, indices): the in-neighbours of v."""
        return coo_to_csr(self.dst, self.src, self.n_nodes)

    def adj_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (np.ones(self.num_edges(), np.float32), (self.src, self.dst)),
            shape=(self.n_nodes, self.n_nodes),
        )

    def to_device(self, device, window_table: bool = False) -> Graph:
        """The device graph; `window_table` marks it as carrying the aligned
        window table (--sampler_tier window on a sampled SAGE teacher)."""
        g = build_graph(self.src, self.dst, self.n_nodes).to(device)
        return g.with_window_table() if window_table else g


def largest_connected_component(g: HostGraph) -> np.ndarray:
    """Node ids of the largest weakly connected component."""
    n_comp, labels = connected_components(g.src, g.dst, g.n_nodes)
    if n_comp == 1:
        return np.arange(g.n_nodes)
    return np.where(labels == np.bincount(labels).argmax())[0]


def rcm_ordering(g: HostGraph) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation (scipy's), a relabelling that
    gathers the edges near the diagonal."""
    perm = sp.csgraph.reverse_cuthill_mckee(g.adj_scipy(),
                                            symmetric_mode=False)
    return np.asarray(perm, np.int64)


def reorder_nodes(g: HostGraph, order) -> HostGraph:
    """Relabel the nodes so that new id i is old id order[i]; `ndata`
    follows."""
    order = np.asarray(order, np.int64)
    new_id = np.empty(g.n_nodes, np.int64)
    new_id[order] = np.arange(g.n_nodes)
    out = HostGraph(new_id[g.src], new_id[g.dst], g.n_nodes)
    out.ndata = {k: v[order] for k, v in g.ndata.items()}
    return out
