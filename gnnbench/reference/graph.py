"""The dst-sorted graph worked out from the handed edge list."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RefGraph:
    """Edges sorted by destination, stably (the handed order within a
    destination). src/dst int64 [E] in that order; indptr int64 [N + 1];
    in/out degrees f32 [N]; the src-sorted (stable) transpose: t_indptr
    [N + 1], t_dst [E], t_edges [E] (each slot's position in the
    dst-sorted order)."""
    src: torch.Tensor
    dst: torch.Tensor
    indptr: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    t_indptr: torch.Tensor
    t_dst: torch.Tensor
    t_edges: torch.Tensor
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def _indptr(keys: torch.Tensor, n: int) -> torch.Tensor:
    counts = torch.bincount(keys, minlength=n)
    out = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def build(src: torch.Tensor, dst: torch.Tensor, n: int) -> RefGraph:
    src, dst = src.long(), dst.long()
    order = torch.sort(dst, stable=True).indices
    s, d = src[order], dst[order]
    del order
    t_order = torch.sort(s, stable=True).indices
    return RefGraph(
        src=s, dst=d, indptr=_indptr(d, n),
        in_degrees=torch.bincount(d, minlength=n).float(),
        out_degrees=torch.bincount(s, minlength=n).float(),
        t_indptr=_indptr(s, n), t_dst=d[t_order], t_edges=t_order,
        n_nodes=n)


def mismatches(port_graph, ref: RefGraph) -> int:
    """How many entries of the port's graph differ from the reference's:
    senders, receivers, the row pointer (its ghost row N included, which
    must be empty), both degree vectors and the transpose. A missing
    array or a wrong length counts as all its entries."""
    n, e = ref.n_nodes, ref.n_edges
    pairs = [("senders", ref.src), ("receivers", ref.dst),
             ("in_degrees", ref.in_degrees), ("out_degrees", ref.out_degrees),
             ("t_indptr", ref.t_indptr), ("t_receivers", ref.t_dst),
             ("t_edges", ref.t_edges)]
    bad = 0
    for name, want in pairs:
        got = getattr(port_graph, name, None)
        if got is None or got.shape != want.shape:
            bad += want.numel()
            continue
        bad += int((got.to(want.device).to(want.dtype) != want).sum())
    ip = port_graph.indptr.to(ref.indptr.device).long()
    want = torch.cat([ref.indptr, ref.indptr[-1:]])     # the empty ghost row
    bad += (int((ip != want).sum()) if ip.shape == want.shape
            else want.numel())
    bad += int(port_graph.n_nodes != n) + int(port_graph.n_edges != e)
    return bad


def row_histogram(indptr: torch.Tensor, edges=(0, 1, 32, 128, 512, 4096,
                                               20000)) -> dict:
    """Rows by in-degree: {"<lo>-<hi>": count} over the bins of `edges`,
    the last open-ended; and the longest row."""
    deg = (indptr[1:] - indptr[:-1]).long()
    out = {}
    for lo, hi in zip(edges, list(edges[1:]) + [None]):
        sel = deg >= lo if hi is None else (deg >= lo) & (deg < hi)
        out[f"{lo}-" if hi is None else f"{lo}-{hi - 1}"] = int(sel.sum())
    out["max"] = int(deg.max()) if deg.numel() else 0
    return out
