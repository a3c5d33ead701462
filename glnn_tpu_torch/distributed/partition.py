"""Host-side graph partitioners (`glnn_tpu/distributed/partition.py`),
numpy only, giving the same arrays as the JAX package's.

A contiguous 1-D node partition into equal blocks of rows; every edge is
owned by its destination's shard, so a shard computes the whole
aggregation of its rows and only the source rows of other shards cross
(distributed/halo.py). The relabelings below permute node ids so that
the equal blocks keep communities together (label propagation, then
whole communities LPT-assigned to shards) or balance the in-edge load.
The label propagation runs the native C++ sweep of the port's host-graph
library (`glnn_tpu_torch.native`) where it is built, else the numpy sweep
here; both give the same labels, as JAX's two tiers do.
"""

from __future__ import annotations

import numpy as np

from glnn_tpu_torch import native


def contiguous_partition(n_nodes: int, n_shards: int) -> np.ndarray:
    """Shard boundaries: node v belongs to shard bisect(bounds, v).
    Returns bounds array of length n_shards+1."""
    base = n_nodes // n_shards
    rem = n_nodes % n_shards
    sizes = np.full(n_shards, base, np.int64)
    sizes[:rem] += 1
    bounds = np.zeros(n_shards + 1, np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds


def edge_cut_fraction(src: np.ndarray, dst: np.ndarray,
                      bounds: np.ndarray) -> float:
    """Fraction of edges whose endpoints live on different shards —
    the halo traffic proxy used by the partition benchmarks."""
    shard_of = np.searchsorted(bounds, np.arange(bounds[-1]), side="right") - 1
    return float((shard_of[src] != shard_of[dst]).mean())


def degree_balanced_order(in_degrees: np.ndarray, n_shards: int
                          ) -> np.ndarray:
    """Node relabeling for edge-balanced equal-size shards.

    Row sharding splits the (padded) node axis into EQUAL blocks,
    so balancing cannot move the boundaries — instead it permutes node
    ids: greedy LPT assignment (heaviest in-degree first, least-loaded
    shard with free capacity) packs ~E/P dst-edges into each block.

    Returns `order`: old node ids in their new order (shard 0's nodes
    first). Relabel a graph with `new_id = inverse_permutation(order)`;
    `new_id[v]` is v's new id.
    """
    import heapq

    deg = np.asarray(in_degrees, np.int64)
    n = deg.shape[0]
    cap = -(-n // n_shards)
    by_deg = np.argsort(-deg, kind="stable")
    buckets: list[list[int]] = [[] for _ in range(n_shards)]
    heap = [(0, p) for p in range(n_shards)]
    heapq.heapify(heap)
    # total capacity P*cap >= n, so the heap never empties before every
    # node is assigned; full buckets simply stop being pushed back
    for v in by_deg:
        load, p = heapq.heappop(heap)
        buckets[p].append(v)
        if len(buckets[p]) < cap:
            heapq.heappush(heap, (load + int(deg[v]), p))
    return np.concatenate([np.asarray(b, np.int64) for b in buckets])


def inverse_permutation(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(order, np.int64))
    inv[order] = np.arange(len(order))
    return inv


def chunked_balanced_order(locality_order: np.ndarray,
                           in_degrees: np.ndarray, n_shards: int,
                           chunks_per_shard: int = 64) -> np.ndarray:
    """Compose locality with load balance: keep a locality-preserving
    ordering (RCM / BFS / community) in contiguous CHUNKS and
    LPT-assign whole chunks to shards by in-degree weight.

    A global LPT permutation (`degree_balanced_order`) balances
    per-shard edge load but scatters neighborhoods across shards —
    measured halo fractions 0.50/0.75/0.87 at P=2/4/8 even on
    clustered graphs. Chunk-granular LPT keeps ~`1/chunks_per_shard`
    of the locality order contiguous per move, so edge cut stays near
    the locality ordering's while worst-shard load drops to chunk
    granularity.

    Returns `order`: old node ids in their new id order (shard 0's
    nodes first). Relabel with `inverse_permutation(order)`.
    """
    import heapq

    order = np.asarray(locality_order, np.int64)
    deg = np.asarray(in_degrees, np.int64)
    n = order.shape[0]
    n_chunks = n_shards * chunks_per_shard
    bnd = np.linspace(0, n, n_chunks + 1).astype(np.int64)
    chunks = [order[bnd[i]:bnd[i + 1]] for i in range(n_chunks)]
    weights = np.array([int(deg[c].sum()) for c in chunks], np.int64)

    by_w = np.argsort(-weights, kind="stable")
    buckets: list[list[int]] = [[] for _ in range(n_shards)]
    heap = [(0, p) for p in range(n_shards)]
    heapq.heapify(heap)
    for ci in by_w:
        load, p = heapq.heappop(heap)
        buckets[p].append(int(ci))
        if len(buckets[p]) < chunks_per_shard:
            heapq.heappush(heap, (load + int(weights[ci]), p))
    # keep chunks in locality order inside each shard
    return np.concatenate(
        [np.concatenate([chunks[ci] for ci in sorted(b)]) if b
         else np.empty(0, np.int64) for b in buckets])


def label_propagation_labels(src: np.ndarray, dst: np.ndarray,
                             n_nodes: int, iters: int = 10,
                             tol: float = 1e-3) -> np.ndarray:
    """Community labels by synchronous label propagation over the
    symmetrized edge set: each sweep, every node adopts the most
    frequent label among its neighbors (ties -> smallest label).

    This is the locality signal the halo partitioners need: RCM
    (bandwidth reduction) recovers almost none of a planted-partition
    graph's structure once ids are shuffled (measured halo fraction
    0.80 at P=8 vs 0.10 for LP on the same graph — bench/scaling.py).
    The native sweep (`native.label_propagation`, O(E log deg) a sweep)
    where the host-graph library is built, which ogbn-products needs; else
    the numpy sweep below (sort + run-length per sweep, O(E log E)), which
    gives the same labels. Returns int64[n] labels.
    """
    lab = native.label_propagation(src, dst, n_nodes, iters)
    if lab is not None:
        return lab
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    ss = np.concatenate([src, dst])
    dd = np.concatenate([dst, src])
    lab = np.arange(n_nodes, dtype=np.int64)
    for _ in range(iters):
        key = dd * n_nodes + lab[ss]
        uniq, cnt = np.unique(key, return_counts=True)
        node = uniq // n_nodes
        lbl = uniq % n_nodes
        ordk = np.lexsort((lbl, -cnt, node))
        node_o, lbl_o = node[ordk], lbl[ordk]
        first = np.ones(len(node_o), bool)
        first[1:] = node_o[1:] != node_o[:-1]
        new = lab.copy()
        new[node_o[first]] = lbl_o[first]
        changed = float((new != lab).mean())
        lab = new
        if changed < tol:
            break
    return lab


def community_balanced_order(labels: np.ndarray, in_degrees: np.ndarray,
                             n_shards: int) -> np.ndarray:
    """Node relabeling that keeps whole communities on one shard while
    LPT-balancing per-shard in-edge load.

    Unlike `chunked_balanced_order` (fixed equal chunks — which cut
    straight through communities and re-scatter them), the atomic unit
    here is a community from `labels`; only communities larger than a
    shard's node capacity are split (into capacity-sized pieces that
    stay contiguous). Greedy LPT by degree weight, subject to the
    equal-node-block capacity the row sharding imposes.

    Returns `order`: old node ids in new id order (shard 0 first).
    Relabel with `inverse_permutation(order)`.
    """
    labels = np.asarray(labels, np.int64)
    deg = np.asarray(in_degrees, np.int64)
    n = labels.shape[0]
    cap = -(-n // n_shards)

    order0 = np.argsort(labels, kind="stable")
    sorted_lab = labels[order0]
    starts = np.concatenate(
        [[0], np.where(np.diff(sorted_lab) != 0)[0] + 1, [n]])
    pieces = []                      # (weight, node_ids)
    for i in range(len(starts) - 1):
        grp = order0[starts[i]:starts[i + 1]]
        for j in range(0, len(grp), cap):
            part = grp[j:j + cap]
            pieces.append((int(deg[part].sum()), part))

    pieces.sort(key=lambda t: -t[0])
    load = np.zeros(n_shards, np.int64)
    used = np.zeros(n_shards, np.int64)
    buckets: list[list[np.ndarray]] = [[] for _ in range(n_shards)]
    for w, part in pieces:
        fits = np.where(used + len(part) <= cap)[0]
        if len(fits) == 0:           # forced spill: least-full shard
            fits = np.array([int(used.argmin())])
        p = fits[np.argmin(load[fits])]
        buckets[p].append(part)
        load[p] += w
        used[p] += len(part)
    return np.concatenate(
        [np.concatenate(b) if b else np.empty(0, np.int64)
         for b in buckets])


def shard_edge_balance(dst: np.ndarray, n_nodes: int,
                       n_shards: int) -> float:
    """max/mean in-edge load across equal node blocks (1.0 = perfect)."""
    rows = -(-n_nodes // n_shards)
    loads = np.bincount(np.asarray(dst, np.int64) // rows,
                        minlength=n_shards)
    return float(loads.max() / max(loads.mean(), 1e-9))
