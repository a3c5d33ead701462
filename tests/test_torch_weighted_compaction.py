"""The weighted walk's compaction in its numpy mirror (tests/hub_walks.py),
and the host side of the walks' gather counter, on the CPU.

With one weight per edge the kernel (csrc/spmm_csr.cu) drops, within each
32-edge window, the edges whose weight is 0 and hands the kept ones to
the edge groups in order. A dropped edge's term is bf16(x * 0) = +-0, so
the compacted walk is the same sum of the same terms in another order:
within 1e-5 of each sum's magnitude of the plain version, exactly equal
on integer values, and, with no weight of 0, bit for bit the walk over
every edge. The card's tests (tests/test_torch_cuda.py) hold the kernel to
the mirror bit for bit."""

import numpy as np
import pytest
import torch

import hub_walks
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import spmm_cuda

HT = spmm_cuda.HUB_CHUNK


def _graph_and_inputs(f, seed, integer):
    """The hub-split graph (rows of 0 to 20 T edges) with x [N, f] and
    weights of which about half are 0."""
    src, dst, n = hub_walks.hub_split_arrays(seed)
    g = build_graph(src, dst, n)
    rs = np.random.RandomState(seed + 1)
    if integer:
        x = rs.randint(-100, 100, (n, f)).astype(np.float32)
        w = 2 * rs.randint(0, 2, g.n_edges).astype(np.float32)
    else:
        x = rs.randn(n, f).astype(np.float32)
        w = (rs.rand(g.n_edges) * 2).astype(np.float32)
        w[rs.rand(g.n_edges) < 0.5] = 0.0
    return g, x, w


def _walks(g):
    """(indptr, indices, widx) of the forward and the transposed walk."""
    return ((g.indptr, g.senders, None),
            (g.t_indptr, g.t_receivers, g.t_edges))


def _mirror(g, x, w, indptr, indices, widx, compact=True):
    n, f = g.n_nodes, x.shape[1]
    return hub_walks.template_walk(
        indptr[:n + 1].numpy(), indices.numpy(), x, n,
        spmm_cuda.geometry(f, 4, f), HT, "weighted", w=w,
        widx=None if widx is None else widx.numpy(), compact=compact)


def _plain(g, x, w, indptr, indices, widx):
    return spmm_cuda.plain_csr_wsum_bf16(
        indptr, indices, widx, torch.from_numpy(x), torch.from_numpy(w),
        g.n_nodes).numpy()


def test_window_ranks_number_the_kept_edges_of_each_window():
    keep = np.zeros(70, bool)
    keep[[0, 2, 3, 31, 32, 40, 64, 69]] = True
    ranks = hub_walks.window_ranks(keep)
    assert ranks[keep].tolist() == [0, 1, 2, 3, 0, 1, 0, 1]


@pytest.mark.parametrize("f", [40, 7, 128])
def test_compacted_walk_matches_plain(f):
    """Half the weights 0: both walks within 1e-5 of each sum's magnitude
    (the plain version on |x|), on rows either side of T and of 20 T."""
    g, x, w = _graph_and_inputs(f, f + 7, integer=False)
    assert 0.4 < float((w == 0).mean()) < 0.6
    for indptr, indices, widx in _walks(g):
        got = _mirror(g, x, w, indptr, indices, widx)
        want = _plain(g, x, w, indptr, indices, widx)
        magnitude = _plain(g, np.abs(x), w, indptr, indices, widx)
        assert np.all(np.abs(got - want) <= 1e-5 * magnitude)
        assert np.abs(got[len(hub_walks.HUB_SPLIT) - 1]).max() > 0


@pytest.mark.parametrize("f", [40, 7, 128])
def test_compacted_walk_is_exact_on_integers(f):
    """Integer rows and weights of 0 or 2 make every sum exact whatever
    its order: the compacted walk equals the plain version bit for bit,
    so it covers each kept edge once and no dropped one."""
    g, x, w = _graph_and_inputs(f, f + 11, integer=True)
    for indptr, indices, widx in _walks(g):
        np.testing.assert_array_equal(
            _mirror(g, x, w, indptr, indices, widx),
            _plain(g, x, w, indptr, indices, widx))


@pytest.mark.parametrize("f", [40, 7, 128])
def test_dense_weights_keep_the_walk_order(f):
    """With no weight of 0 the compacted walk is the walk over every edge,
    bit for bit."""
    g, x, w = _graph_and_inputs(f, f + 13, integer=False)
    w = np.where(w == 0, np.float32(0.5), w)
    for indptr, indices, widx in _walks(g):
        np.testing.assert_array_equal(
            _mirror(g, x, w, indptr, indices, widx),
            _mirror(g, x, w, indptr, indices, widx, compact=False))


def test_gather_counter_counts_only_under_a_profiler(monkeypatch):
    """`_gather_counter` hands a walk its per-item counter only while a
    profiler runs (`recording`, stood in for here), counting the edges
    walked; the counter grows keeping its counts, `gather_counts` sums
    them, and `reset_counts` zeroes both."""
    cpu = torch.device("cpu")
    spmm_cuda.reset_counts()
    assert not spmm_cuda.recording()
    assert spmm_cuda._gather_counter(cpu, 8, 100) is None
    assert spmm_cuda.gather_counts() == {"walked": 0, "gathered": 0}
    monkeypatch.setattr(spmm_cuda, "recording", lambda: True)
    small = spmm_cuda._gather_counter(cpu, 8, 100)
    small[:] = torch.arange(8, dtype=torch.int32)
    grown = spmm_cuda._gather_counter(cpu, 12, 50)
    assert spmm_cuda._gather_counter(cpu, 4, 25) is grown
    assert small.dtype == torch.int32 and grown.numel() == 12
    assert grown[:8].tolist() == list(range(8))
    assert spmm_cuda.gather_counts() == {"walked": 175, "gathered": 28}
    spmm_cuda.reset_counts()
    assert spmm_cuda.gather_counts() == {"walked": 0, "gathered": 0}
