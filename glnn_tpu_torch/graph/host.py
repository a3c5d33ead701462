"""Host-side graph: COO edges, node features and the edge surgery that
ingest needs.

Counterpart of `glnn_tpu/graph/host.py`, reduced to what the ported
datasets and the inductive split use. `to_bidirected` and
`induced_subgraph` are local numpy copies of the fallbacks in
`glnn_tpu/native/__init__.py` (:105-118, :147-150), which give the same
edge order as the native library (to_bidirected sorts by the key
src * n + dst; induced_subgraph keeps the edges' order).
"""

from __future__ import annotations

import numpy as np

from glnn_tpu_torch.graph.container import Graph, build_graph


def to_bidirected(src, dst, n: int):
    """Symmetrise and deduplicate, sorted by (src, dst)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    _, keep = np.unique(s2 * n + d2, return_index=True)
    return s2[keep], d2[keep]


def induced_subgraph(src, dst, n: int, idx):
    """The edges with both ends in idx, relabelled so that new id i is
    idx[i], in their original order (self-loops on idx survive)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    idx = np.asarray(idx, np.int64)
    new_id = np.full(n, -1, np.int64)
    new_id[idx] = np.arange(idx.shape[0])
    keep = (new_id[src] >= 0) & (new_id[dst] >= 0)
    return new_id[src[keep]], new_id[dst[keep]]


class HostGraph:
    """COO edges plus `ndata` node features (the reference's `g`)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.n_nodes = int(n_nodes)
        self.ndata: dict[str, np.ndarray] = {}

    def number_of_nodes(self) -> int:
        return self.n_nodes

    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def number_of_edges(self) -> int:
        return self.num_edges()

    def _with_edges(self, src, dst) -> "HostGraph":
        g = HostGraph(src, dst, self.n_nodes)
        g.ndata = dict(self.ndata)
        return g

    def to_bidirected(self) -> "HostGraph":
        return self._with_edges(*to_bidirected(self.src, self.dst,
                                               self.n_nodes))

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

    def to_device(self, device, window_table: bool = False) -> Graph:
        """The device graph; `window_table` marks it as carrying the aligned
        window table (--sampler_tier window on a sampled SAGE teacher)."""
        g = build_graph(self.src, self.dst, self.n_nodes).to(device)
        return g.with_window_table() if window_table else g
