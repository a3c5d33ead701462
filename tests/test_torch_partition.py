"""The port's host-side partitioners and halo index sets against
`glnn_tpu` (exact arrays, no processes), and the sharded paths' rules:
the rank -> device and backend rule, and a failing rank ending a launch.
The combined CSR of the per-edge halo ops is held to `build_graph` in
tests/test_torch_halo_attention.py."""

import numpy as np
import pytest
import torch

from glnn_tpu_torch.distributed import mesh
from glnn_tpu_torch.distributed import partition as tp
from glnn_tpu_torch.distributed.halo import build_halo_graph
from native_tiers import tier  # noqa: F401  (fixture: native, numpy)


def _planted(seed, n=600, k=6, e=5000, p_in=0.9):
    """Planted-partition edges over shuffled ids."""
    rs = np.random.RandomState(seed)
    comm = rs.randint(0, k, n)
    src = rs.randint(0, n, e)
    same = rs.rand(e) < p_in
    members = [np.nonzero(comm == c)[0] for c in range(k)]
    dst = np.where(same, [rs.choice(members[comm[s]]) for s in src],
                   rs.randint(0, n, e))
    return src.astype(np.int64), dst.astype(np.int64), n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_partitioners_equal_jax(seed, n_shards):
    from glnn_tpu.distributed import partition as jp

    src, dst, n = _planted(seed)
    deg = np.bincount(dst, minlength=n)
    np.testing.assert_array_equal(tp.contiguous_partition(n, n_shards),
                                  jp.contiguous_partition(n, n_shards))
    bounds = tp.contiguous_partition(n, n_shards)
    assert tp.edge_cut_fraction(src, dst, bounds) == jp.edge_cut_fraction(
        src, dst, bounds)
    order = tp.degree_balanced_order(deg, n_shards)
    np.testing.assert_array_equal(order, jp.degree_balanced_order(deg,
                                                                  n_shards))
    np.testing.assert_array_equal(tp.inverse_permutation(order),
                                  jp.inverse_permutation(order))
    locality = np.random.RandomState(seed).permutation(n)
    np.testing.assert_array_equal(
        tp.chunked_balanced_order(locality, deg, n_shards, 4),
        jp.chunked_balanced_order(locality, deg, n_shards, 4))
    assert tp.shard_edge_balance(dst, n, n_shards) == jp.shard_edge_balance(
        dst, n, n_shards)


@pytest.mark.parametrize("seed", [0, 1])
def test_label_propagation_and_community_order_equal_jax(seed, tier):
    """On both tiers of the port's library, against JAX's label
    propagation, which goes native where its library is built
    (tests/test_native.py holds it equal to its numpy sweep)."""
    from glnn_tpu.distributed import partition as jp

    src, dst, n = _planted(seed)
    labels = tp.label_propagation_labels(src, dst, n)
    np.testing.assert_array_equal(labels,
                                  jp.label_propagation_labels(src, dst, n))
    deg = np.bincount(dst, minlength=n)
    np.testing.assert_array_equal(tp.community_balanced_order(labels, deg, 8),
                                  jp.community_balanced_order(labels, deg, 8))


@pytest.mark.parametrize("seed", [0, 3])
def test_build_halo_graph_equals_jax(seed, tier):
    """P = 8: per shard, the global (src, dst) multisets of the local and of
    the halo edges (JAX's ghost slots dropped), the send lists in order and
    the degrees equal JAX's."""
    import jax

    from glnn_tpu.distributed.halo import build_halo_graph as jax_build
    from glnn_tpu.distributed.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    src, dst, n = _planted(seed, n=203)
    hj = jax_build(src, dst, n, make_mesh(8, axis="graph"))
    shards = build_halo_graph(src, dst, n, 8)
    rows, h = hj.rows_per_shard, hj.halo_rows
    assert all(s.rows == rows for s in shards)
    send_j = np.asarray(hj.send_idx)
    sends = [np.split(s.send_idx.numpy(), np.cumsum(s.send_splits)[:-1])
             for s in shards]
    for q in range(8):
        for p in range(8):
            want = send_j[q, p][send_j[q, p] < rows]
            np.testing.assert_array_equal(sends[q][p], want)
            assert shards[q].send_splits[p] == len(want)
            assert shards[p].recv_splits[q] == len(want)

    def edges(a, b):
        return sorted(zip(a.tolist(), b.tolist()))

    for p, s in enumerate(shards):
        base = p * rows
        row_of = np.repeat(np.arange(rows), np.diff(s.indptr.numpy()))
        lsrc, ldst = np.asarray(hj.local_src[p]), np.asarray(hj.local_dst[p])
        keep = ldst < rows
        assert edges(s.indices.numpy() + base, row_of + base) == edges(
            lsrc[keep] + base, ldst[keep] + base)
        recv = np.concatenate([sends[q][p] + q * rows for q in range(8)])
        row_of = np.repeat(np.arange(rows), np.diff(s.halo_indptr.numpy()))
        hgat, hdst = np.asarray(hj.halo_gather[p]), np.asarray(hj.halo_dst[p])
        keep = hdst < rows
        g = hgat[keep]
        jsrc = send_j[g // h, p, g % h] + (g // h) * rows
        assert edges(recv[s.halo_indices.numpy()], row_of + base) == edges(
            jsrc, hdst[keep] + base)
        for name in ("in_degrees", "out_degrees"):
            np.testing.assert_array_equal(
                getattr(s, name).numpy(),
                np.asarray(getattr(hj, name))[base:base + rows])


def test_transposes_hold_the_same_edges():
    src, dst, n = _planted(2, n=150)
    for s in build_halo_graph(src, dst, n, 4):
        for fwd, bwd, n_src in ((("indptr", "indices"),
                                 ("t_indptr", "t_indices"), s.rows),
                                (("halo_indptr", "halo_indices"),
                                 ("halo_t_indptr", "halo_t_indices"),
                                 s.n_recv)):
            ptr, idx = (getattr(s, k).numpy() for k in fwd)
            tptr, tidx = (getattr(s, k).numpy() for k in bwd)
            a = sorted(zip(np.repeat(np.arange(s.rows), np.diff(ptr)), idx))
            b = sorted(zip(tidx, np.repeat(np.arange(n_src), np.diff(tptr))))
            assert a == b


def test_device_and_backend_rule(monkeypatch):
    monkeypatch.delenv(mesh.SHARE_DEVICE_ENV, raising=False)
    assert mesh.plan_devices(-1, 4) == ([torch.device("cpu")] * 4, "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.plan_devices(0, 2) == ([torch.device("cuda:0"),
                                        torch.device("cuda:1")], "nccl")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        mesh.plan_devices(1, 4)
    monkeypatch.setenv(mesh.SHARE_DEVICE_ENV, "1")
    assert mesh.plan_devices(1, 4) == ([torch.device("cuda:1")] * 4, "gloo")


def _fail_on_rank_one(m, payload):
    if m.rank == 1:
        raise KeyError("rank one fails")
    torch.distributed.barrier()      # rank 0 waits in a collective
    return payload


def test_a_failing_rank_ends_the_launch():
    with pytest.raises(RuntimeError, match="rank one fails"):
        mesh.launch(_fail_on_rank_one, [0, 1], -1, timeout=60)
