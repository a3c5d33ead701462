"""glnn_tpu_torch host ingest and graph container against glnn_tpu, the
container's tests on both tiers of the host-graph library (`tier`)."""

import numpy as np
import pytest
import torch

from glnn_tpu.graph import graph_from_csr as jax_graph_from_csr
from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.graph.datasets import load_synth_data as jax_load_synth
from glnn_tpu_torch.graph import graph_from_csr
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.graph.datasets import load_data, load_synth_data
from native_tiers import tier  # noqa: F401  (fixture: native, numpy)

SYNTH = "synth-n512-c5-f32-d8-noise3.0"


def _assert_same_graph(gt, gj):
    for name in ("senders", "receivers", "indptr", "in_degrees",
                 "out_degrees"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    assert (gt.n_nodes, gt.n_edges) == (gj.n_nodes, gj.n_edges)


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_data_identical_to_jax(seed, tier):
    gt, lt, *it = load_synth_data(SYNTH, seed, 20, 30)
    gj, lj, *ij = jax_load_synth(SYNTH, seed, 20, 30)
    np.testing.assert_array_equal(gt.ndata["feat"], gj.ndata["feat"])
    np.testing.assert_array_equal(lt, lj)
    for a, b in zip(it, ij):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt.src, gj.src)
    np.testing.assert_array_equal(gt.dst, gj.dst)
    _assert_same_graph(build_graph(gt.src, gt.dst, gt.n_nodes),
                       jax_build_graph(gj.src, gj.dst, gj.n_nodes))


def test_tiny_graph_csc_identical_to_jax(tiny_graph, tier):
    g = build_graph(tiny_graph.src, tiny_graph.dst, tiny_graph.n_nodes)
    _assert_same_graph(g, jax_build_graph(tiny_graph.src, tiny_graph.dst,
                                          tiny_graph.n_nodes))
    assert g.indptr.shape == (tiny_graph.n_nodes + 2,)


def test_transposed_csr_is_the_src_sorted_edge_set(tiny_graph, tier):
    from conftest import dense_adj

    g = build_graph(tiny_graph.src, tiny_graph.dst, tiny_graph.n_nodes)
    a_t = np.zeros((g.n_nodes, g.n_nodes), np.float32)   # A^T[src, dst]
    tp, tr = g.t_indptr.numpy(), g.t_receivers.numpy()
    for u in range(g.n_nodes):
        for v in tr[tp[u]:tp[u + 1]]:
            a_t[u, v] += 1.0
    np.testing.assert_array_equal(a_t, dense_adj(tiny_graph).T)
    assert all(g.t_indptr.numpy()[1:] >= g.t_indptr.numpy()[:-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_t_edges_point_each_src_slot_at_its_dst_sorted_edge(seed, tier):
    """t_edges is a permutation of the dst-sorted edge ids; slot k of the
    transposed CSR names an edge whose source owns the slot and whose
    destination is t_receivers[k]; within a source the edges keep their
    dst-sorted order (the stable sort)."""
    rs = np.random.RandomState(seed)
    n = 40
    g = build_graph(rs.randint(0, n, 400), rs.randint(5, n, 400), n)
    te, tp = g.t_edges.numpy(), g.t_indptr.numpy()
    assert g.t_edges.dtype == torch.int32 and te.shape == (g.n_edges,)
    np.testing.assert_array_equal(np.sort(te), np.arange(g.n_edges))
    np.testing.assert_array_equal(g.receivers.numpy()[te],
                                  g.t_receivers.numpy())
    owner = np.repeat(np.arange(n), np.diff(tp))
    np.testing.assert_array_equal(g.senders.numpy()[te], owner)
    for u in range(n):
        assert (np.diff(te[tp[u]:tp[u + 1]]) > 0).all()


@pytest.mark.parametrize("src,dst", [([0, 3], [1, 2]), ([0, 1], [-1, 2])])
def test_build_graph_rejects_out_of_range_endpoints(src, dst, tier):
    with pytest.raises(ValueError, match="endpoints"):
        build_graph(np.array(src), np.array(dst), 3)



@pytest.mark.parametrize("seed", [0, 1])
def test_graph_from_csr_identical_to_jax(seed, tier):
    """A random CSR multigraph (repeated edges, self-loops, nodes with no
    edge at all) gives glnn_tpu's arrays: indptr, the dst-sorted edge order,
    degrees; and the transposed CSR of `build_graph` over the same COO."""
    rs = np.random.RandomState(seed)
    n = 60
    isolated = rs.choice(n, 6, replace=False)
    out_deg = rs.randint(0, 9, n)
    out_deg[isolated] = 0
    indptr = np.concatenate([[0], np.cumsum(out_deg)])
    live = np.setdiff1d(np.arange(n), isolated)
    indices = rs.choice(live, indptr[-1])
    src = np.repeat(np.arange(n), out_deg)
    indices[::7] = src[::7]                       # self-loops
    assert (np.bincount(indices, minlength=n)[isolated] == 0).all()
    assert len(np.unique(src * n + indices)) < len(src)    # multi-edges

    g = graph_from_csr(indptr, indices, n)
    _assert_same_graph(g, jax_graph_from_csr(indptr, indices, n))
    want = build_graph(src, indices, n)
    for name in ("t_indptr", "t_receivers", "t_edges"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert g.in_degrees[isolated].sum() == g.out_degrees[isolated].sum() == 0

def test_graph_to_keeps_fields():
    g = build_graph(np.array([0, 1, 2]), np.array([1, 2, 0]), 3)
    h = g.to("cpu")
    assert h.n_edges == 3 and h.device.type == "cpu"
    assert all(t.dtype == torch.int32 for t in
               (h.senders, h.receivers, h.indptr, h.t_indptr, h.t_receivers,
                h.t_edges))


@pytest.mark.parametrize("name", ["cora", "ogbn-arxiv", "penn94",
                                  "vk_class"])
def test_unported_loaders_raise(name, tmp_path, monkeypatch):
    """Every family is ported: without its files, each loader raises what
    glnn_tpu's raises (ValueError for CPF and OGB, FileNotFoundError for
    NonHom and BGNN), naming the missing file."""
    from glnn_tpu.graph.datasets import load_data as jax_load_data

    monkeypatch.chdir(tmp_path)
    kw = dict(seed=0, labelrate_train=20, labelrate_val=30, split_idx=0)
    with pytest.raises((ValueError, FileNotFoundError)) as want:
        jax_load_data(name, "./data", **kw)
    with pytest.raises(want.type, match=name):
        load_data(name, "./data", **kw)


def test_config_precedence_and_synth_fallback(tmp_path):
    from glnn_tpu_torch.cli.common import DEFAULT_CONFIG
    from glnn_tpu_torch.utils.config import (get_training_config,
                                             merge_args_with_config)

    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "defaults:\n  num_layers: 2\n\ncora:\n  GCN:\n    hidden_dim: 64\n")
    conf = get_training_config(str(cfg), "GCN", "cora")
    merged = merge_args_with_config({"hidden_dim": 999, "lr": 0.1}, conf)
    assert merged["hidden_dim"] == 64 and merged["lr"] == 0.1
    assert merged["model_name"] == "GCN"
    assert get_training_config(DEFAULT_CONFIG, "SAGE",
                               "synth-n512-c5")["fan_out"] == "5,5"


def test_set_seed_pins_python_numpy_torch():
    import random

    from glnn_tpu_torch.utils import set_seed

    set_seed(7)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    set_seed(7)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
