"""Multi-layer uniform neighbour sampling (`glnn_tpu/sampling/sampler.py`):
the Floyd and window tiers, in concat or dedup mode.

Fanout semantics as DGL 0.6.1: a node with deg <= fanout takes every
in-neighbour once; a node with deg > fanout draws a uniform k-subset
without replacement (Floyd's algorithm, vectorised over the frontier).

Tiers (`method`): "floyd" reads edge start + off of each drawn offset.
"window" keeps the same offsets but folds them into a window of the
node's edges, as JAX's window tier reads them:
  * on a graph that carries the aligned window table
    (`Graph.with_window_table`): edge start + off % clip(deg, 1, 64), so a
    node of more than 64 in-edges samples from its first 64; equal to
    Floyd for deg <= WINDOW1_EXACT_DEG (64);
  * without it: the two 64-wide rows of the reshaped edge array that hold
    the node's first edge, so edge start + off % cap with
    cap = max(min(deg, 128 - start % 64), 1); equal to Floyd for
    deg <= WINDOW_EXACT_DEG (65) at any alignment.
The heavier nodes' fold biases the sample towards their first edges (the
JAX package's documented bias). The TPU's row reads and one-hot lane
selection are gather geometry; one index gather of the folded edge gives
the same id.

Frontier modes:
  * concat (the default without caps): frontier i is [frontier i+1, its
    sampled neighbours flattened], so conv i reads its neighbours as
    static slices and no sort/unique is needed. Duplicate nodes are
    computed more than once, as in the JAX package.
  * dedup (the default with `caps`): frontier i is the sorted unique ids
    of [frontier i+1, its sampled neighbours], capped at caps[i] (the
    smallest ids are kept; `overflowed` is set when real ids were cut),
    padded with the ghost id, plus one trailing ghost slot; local indices
    come from a left searchsorted into it.
Ghost rows (node id n_nodes) sample nothing and gather zero features;
`out_real` masks them out of the batch-norm statistics.

Random numbers: the uniforms u[c, fanout] of each hop come from a
torch.Generator, or are passed in (`uniforms`), which lets a test feed the
JAX package's own draws and compare bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from glnn_tpu_torch.graph.container import Graph

# the window tier's geometry (glnn_tpu/sampling/sampler.py:93-100): WIN-wide
# rows, WIN_ROWS of them per node without the aligned table
WIN = 64
WIN_ROWS = 2
WINDOW_EXACT_DEG = WIN * (WIN_ROWS - 1) + 1
WINDOW1_EXACT_DEG = WIN
METHODS = ("floyd", "window")


@dataclasses.dataclass(frozen=True)
class SampledBlocks:
    """Blocks for an L-layer sampled forward.

    input_nodes: int32[C0] global ids whose features feed conv 0 (ghost
                 id n_nodes for padding).
    nbr_local:   tuple of L int32[n_out_i, K_i] neighbour rows in conv i's
                 input (dedup mode; empty in concat mode).
    valid:       tuple of L bool[n_out_i, K_i] real-neighbour masks.
    self_local:  tuple of L int32[n_out_i] each output's own input row
                 (dedup mode; empty in concat mode).
    out_real:    tuple of L bool[n_out_i] real (non-ghost) output rows.
    overflowed:  a dedup frontier hit its cap (a bool[] tensor); False in
                 concat mode, whose frontiers are sized for the worst case.
    concat:      the frontiers are concatenations, so conv i's neighbours
                 are the rows n_out + arange(n_out * K) and its outputs the
                 first n_out rows (static slices, no gather): the local
                 indices that JAX builds by arithmetic are left implicit.
    """

    input_nodes: torch.Tensor
    nbr_local: tuple
    valid: tuple
    self_local: tuple
    out_real: tuple
    overflowed: torch.Tensor | bool
    concat: bool = False


def frontier_caps(batch_size: int, fanouts: Sequence[int],
                  n_nodes: int) -> list[int]:
    """Worst-case frontier capacities, outermost (input) first."""
    caps = [batch_size]
    for f in reversed(list(fanouts)):
        caps.insert(0, min(caps[0] * (f + 1), n_nodes))
    return caps


def sample_one_hop(g: Graph, frontier: torch.Tensor, fanout: int,
                   u: torch.Tensor, method: str = "floyd"):
    """Uniform in-neighbour sampling for each frontier node, given the
    uniforms u [C, fanout]. Returns (nbr_global int32 [C, K],
    valid bool [C, K])."""
    if method not in METHODS:
        raise ValueError(f"unknown sampler method {method!r}")
    n = g.n_nodes
    is_real = frontier < n
    f_safe = torch.clamp(frontier, max=n - 1).long()
    start = g.indptr[f_safe]
    deg = torch.where(is_real, g.indptr[f_safe + 1] - start,
                      torch.zeros_like(start))

    c = frontier.shape[0]
    j = torch.arange(fanout, dtype=torch.int32, device=frontier.device)[None, :]
    # Floyd: at step i consider slot jcol = deg-k+i; draw t ~ U[0, jcol];
    # take jcol if t was already selected, else t. floor(u * (jcol + 1))
    # is taken in float32, as in the JAX sampler.
    sel = torch.full((c, fanout), -1, dtype=torch.int32, device=frontier.device)
    for i in range(fanout):
        jcol = deg - fanout + i
        t = torch.floor(u[:, i] * (jcol + 1).to(torch.float32)).to(torch.int32)
        t = torch.minimum(torch.clamp(t, min=0), torch.clamp(jcol, min=0))
        member = (sel == t[:, None]).any(dim=1)
        sel[:, i] = torch.where(member, jcol, t)

    take_all = (deg <= fanout)[:, None]
    off = torch.where(take_all, j, sel)
    valid = torch.where(take_all, j < deg[:, None], (deg > 0)[:, None])
    if method == "window":
        if g.win1:
            cap = torch.clamp(deg, 1, WIN)
        else:
            cap = torch.clamp(torch.minimum(deg, WIN_ROWS * WIN - start % WIN),
                              min=1)
        off = off % cap[:, None]
    edge_idx = (start[:, None] + off).long().clamp(0, max(g.n_edges - 1, 0))
    nbr = g.senders[edge_idx]
    nbr = torch.where(valid, nbr, torch.full_like(nbr, n))
    return nbr.to(torch.int32), valid


def sample_blocks(g: Graph, seeds: torch.Tensor, fanouts: Sequence[int],
                  gen: torch.Generator | None = None,
                  uniforms: Sequence[torch.Tensor] | None = None,
                  caps: Sequence[int] | None = None,
                  dedup: bool | None = None,
                  method: str = "floyd") -> SampledBlocks:
    """Sample L-layer blocks for `seeds` (int32[B], ghost-padded ok).
    `uniforms[i]` ([n_out_i, fanouts[i]] float32), when given, replaces the
    draws of hop i; n_out_i is the length of frontier i+1. Dedup mode is
    the default when `caps` are given (worst-case caps when dedup=True
    without them)."""
    fanouts = [int(f) for f in fanouts]
    if dedup is None:
        dedup = caps is not None
    n_layers = len(fanouts)
    n = g.n_nodes
    frontiers = [None] * (n_layers + 1)
    nbrs = [None] * n_layers
    valids = [None] * n_layers
    frontiers[n_layers] = seeds.to(torch.int32)
    overflow = False
    if dedup and caps is None:
        caps = frontier_caps(seeds.shape[0], fanouts, n)
    for i in range(n_layers - 1, -1, -1):
        out_nodes = frontiers[i + 1]
        k = fanouts[i]
        if uniforms is not None:
            u = uniforms[i].to(out_nodes.device)
        else:
            u = torch.rand((out_nodes.shape[0], k), generator=gen,
                           device=out_nodes.device)
        nbrs[i], valids[i] = sample_one_hop(g, out_nodes, k, u, method)
        pool = torch.cat([out_nodes, nbrs[i].reshape(-1)])
        if not dedup:
            frontiers[i] = pool
            continue
        uniq = torch.unique(pool, sorted=True)[: caps[i]]
        # ghost padding up to the cap, then the guaranteed ghost slot
        uniq = torch.cat([uniq, uniq.new_full((caps[i] + 1 - uniq.shape[0],),
                                              n)])
        overflow = overflow | (uniq[caps[i] - 1] < n)
        frontiers[i] = uniq

    nbr_local, self_local, out_real = [], [], []
    for i in range(n_layers):
        out_nodes = frontiers[i + 1]
        out_real.append(out_nodes < n)
        if dedup:
            fin = frontiers[i]
            nbr_local.append(torch.searchsorted(fin, nbrs[i], out_int32=True))
            self_local.append(torch.searchsorted(fin, out_nodes,
                                                 out_int32=True))
    # conv i < L-1 outputs rows for frontier i+1 including its trailing
    # ghost slot (dedup); the ghost row computes on zeros and is dropped
    # by the next conv's gathers
    return SampledBlocks(input_nodes=frontiers[0], nbr_local=tuple(nbr_local),
                         valid=tuple(valids), self_local=tuple(self_local),
                         out_real=tuple(out_real), overflowed=overflow,
                         concat=not dedup)
