"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no CUDA device is present. Run on a
GPU machine with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the suite's conftest imports JAX, which the port
does not need). Tolerances: the exact SpMM kernel and its plain version
differ only in summation order (rtol 1e-5, atol 1e-4); int8 sums are exact
(bit-equal). The GAT kernels differ from their plain versions in summation
order and in the forward's online softmax, which rescales its running sums
when the segment max rises: f32 outputs at rtol 1e-4 / atol 1e-4 x max;
the bf16 message by at most one bf16 ulp (rtol 2**-7), since a last-bit
f32 difference can round either way; the segment max is exact. The
weighted SpMM rounds the same f32 products as its plain version and
differs in summation order only (rtol 1e-5, atol 1e-4); the segment
softmax differs in the order of its f32 sums (rtol 1e-5 forward, 1e-4 for
the gradient, as tests/test_pallas.py:368,421).

Every kernel walks a dst row's edges in chunks of 32, so each kernel test
also runs on a hub graph (`_hub_graph`) whose first rows have the in- and
out-degrees HUB_DEGREES: empty, one edge, either side of one and of two
chunks, and rows of about a thousand and twenty thousand edges.
"""

import numpy as np
import pytest
import torch

from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


HUB_DEGREES = (0, 1, 31, 32, 33, 64, 65, 1000, 20000)
HUB_NODES = 25000
SPMM_WIDTHS = [1, 7, 40, 64, 100, 128, 256, 300]
GAT_SHAPES = [(8, 16), (1, 40), (2, 7), (3, 5)]
WEIGHTED_SHAPES = [(None, 1), (None, 7), (None, 40), (None, 64), (None, 100),
                   (None, 128), (8, 16), (1, 40), (3, 5), (2, 7)]
SOFTMAX_HEADS = [None, 1, 3, 8, 40]


def _graph(n, e, seed, device, hub_free=0):
    """Random graph whose first `hub_free` nodes receive no edges."""
    rs = np.random.RandomState(seed)
    return build_graph(rs.randint(0, n, e), rs.randint(hub_free, n, e),
                       n).to(device)


def _hub_graph(n, e, seed, device):
    """Random graph whose node i < len(HUB_DEGREES) has exactly
    HUB_DEGREES[i] in-edges and as many out-edges (so the transposed walk
    meets the same rows), from and to distinct other nodes as in a graph
    without multi-edges, so n must exceed max(HUB_DEGREES); the other e
    edges join the remaining nodes uniformly. Node 0 is the zero-degree
    row."""
    rs = np.random.RandomState(seed)
    k = len(HUB_DEGREES)
    hubs = np.repeat(np.arange(k), HUB_DEGREES)
    ends = [np.concatenate([rs.choice(np.arange(k, n), d, replace=False)
                            for d in HUB_DEGREES]) for _ in range(2)]
    src = np.concatenate([ends[0], hubs, rs.randint(k, n, e)])
    dst = np.concatenate([hubs, ends[1], rs.randint(k, n, e)])
    return build_graph(src, dst, n).to(device)


def _spmm_matches_plain(g, f, zero_rows):
    x = torch.randn((g.n_nodes, f), device=g.device)
    xb = spmm_cuda.to_message(x)
    # the forward walk, then the transposed walk of the exact tier's backward
    for indptr, cols in ((g.indptr, g.senders), (g.t_indptr, g.t_receivers)):
        got = spmm_cuda.csr_sum_bf16(indptr, cols, xb, g.n_nodes)
        want = spmm_cuda.plain_csr_sum_bf16(indptr, cols, xb, g.n_nodes)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        if indptr is g.indptr:                            # zero in-degree rows
            assert got[zero_rows].abs().max().item() == 0.0

    q, s = spmm_cuda.quantize_cols(x)
    got = spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, g.n_nodes)
    want = spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s, g.n_nodes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("f", SPMM_WIDTHS)
def test_kernels_match_plain(cuda, f):
    _spmm_matches_plain(_graph(500, 6000, f, cuda, hub_free=20), f,
                        slice(0, 20))


@pytest.mark.parametrize("f", SPMM_WIDTHS)
def test_kernels_match_plain_on_hub_rows(cuda, f):
    g = _hub_graph(HUB_NODES, 6000, f, cuda)
    assert g.in_degrees[:len(HUB_DEGREES)].tolist() == list(HUB_DEGREES)
    _spmm_matches_plain(g, f, slice(0, 1))


def test_gradient_matches_plain_backward(cuda):
    g = _graph(400, 5000, 3, cuda)
    x = torch.randn((g.n_nodes, 96), device=cuda, requires_grad=True)
    dh = torch.randn((g.n_nodes, 96), device=cuda)
    want = spmm_cuda.plain_csr_sum_bf16(
        g.t_indptr, g.t_receivers, spmm_cuda.to_message(dh), g.n_nodes)
    for op in (spmm_cuda.copy_u_sum, spmm_cuda.copy_u_sum_int8):
        (got,) = torch.autograd.grad(op(g, x), x, dh)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_launch_counters_and_no_plain_calls(cuda):
    g = _graph(300, 2000, 4, cuda)
    x = torch.randn((g.n_nodes, 32), device=cuda)
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    spmm_cuda.copy_u_sum(g, x)
    spmm_cuda.copy_u_sum_int8(g, x)
    spmm_cuda.u_mul_e_sum(g, x, torch.rand(g.n_edges, device=cuda))
    assert spmm_cuda.counts == {"spmm_csr_bf16": 1, "spmm_csr_int8": 1,
                                "spmm_csr_weighted": 1}
    assert cuda_build.counts == {"plain_on_cuda": 0}


def test_empty_graph_rows(cuda):
    g = build_graph(np.zeros(0, np.int64), np.zeros(0, np.int64), 10).to(cuda)
    x = torch.randn((10, 16), device=cuda)
    out = spmm_cuda.copy_u_sum(g, x)
    torch.cuda.synchronize()
    assert out.abs().max().item() == 0.0


def _close(got, want, rtol=1e-4, scale=1e-4):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=scale * want.abs().max().item() + 1e-12)


def _gat_inputs(g, h, d, drop, seed):
    gen = torch.Generator(device=g.device).manual_seed(seed)
    feat = torch.randn((g.n_nodes, h, d), generator=gen, device=g.device)
    al = 0.3 * torch.randn((h, d), generator=gen, device=g.device)
    ar = 0.3 * torch.randn((h, d), generator=gen, device=g.device)
    keep = (torch.rand((g.n_edges, h), generator=gen, device=g.device) >= drop
            if drop else None)
    return feat, al, ar, keep


def _gat_matches_plain(g, h, d, drop, zero_rows):
    feat, al, ar, keep = _gat_inputs(g, h, d, drop, 1)
    inv_keep = 1.0 / (1.0 - drop)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep, inv_keep, 0.2)
    out, smax, denom = gat_cuda.gat_fwd(*args)
    want = gat_cuda.plain_gat_fwd(*args)
    torch.cuda.synchronize()
    _close(out, want[0])
    assert torch.equal(smax, want[1])
    _close(denom, want[2], rtol=1e-5, scale=1e-6)
    assert out[zero_rows].abs().max().item() == 0.0  # zero in-degree rows

    dout = torch.randn_like(feat)
    got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b)
    want = gat_cuda.plain_gat_bwd(*args, want[1], want[2], dout, al_b)
    torch.cuda.synchronize()
    _close(got[0], want[0])
    _close(got[1], want[1], rtol=2.0 ** -7, scale=1e-5)
    _close(got[2], want[2])
    assert got[0][zero_rows].abs().max().item() == 0.0


@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_kernels_match_plain(cuda, h, d, drop):
    _gat_matches_plain(_graph(600, 7000, h * 10 + d, cuda, hub_free=25), h,
                       d, drop, slice(0, 25))


@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_kernels_match_plain_on_hub_rows(cuda, h, d, drop):
    _gat_matches_plain(_hub_graph(HUB_NODES, 7000, h * 10 + d, cuda), h, d,
                       drop, slice(0, 1))


def test_gat_layer_runs_the_kernels_and_no_plain_version(cuda):
    """ops.gat_attention on CUDA tensors: one forward and one backward
    kernel, the SpMM source reduce, no plain call; its gradient equals the
    plain versions' chain."""
    g = _graph(500, 6000, 11, cuda, hub_free=10)
    feat, al, ar, keep = _gat_inputs(g, 4, 8, 0.0, 2)
    leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
    dout = torch.randn_like(feat)
    spmm_cuda.reset_counts()
    gat_cuda.reset_counts()
    cuda_build.reset_counts()
    out = ops.gat_attention(g, *leaves)
    out.backward(dout)
    assert gat_cuda.counts == {"gat_fwd": 1, "gat_bwd": 1,
                               "edge_softmax_fwd": 0, "edge_softmax_bwd": 0}
    assert spmm_cuda.counts == {"spmm_csr_bf16": 1, "spmm_csr_int8": 0,
                                "spmm_csr_weighted": 0}
    assert cuda_build.counts == {"plain_on_cuda": 0}

    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, None, 1.0, 0.2)
    want_out, smax, denom = gat_cuda.plain_gat_fwd(*args)
    der, msg, dal = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
    dfeat = torch.zeros_like(feat).index_add_(0, g.senders, msg.float())
    dfeat += der[:, :, None] * ar[None]
    _close(out, want_out)
    # a message element that the two round to neighbouring bf16 values moves
    # its source's gradient by one bf16 ulp of that element
    _close(leaves[0].grad, dfeat, rtol=1e-2, scale=1e-2)
    _close(leaves[1].grad, dal)
    _close(leaves[2].grad, torch.einsum("nh,nhd->hd", der, feat))


def test_unported_edge_ops_raise_on_cuda(cuda):
    """The edge ops launch their kernels on CUDA tensors in the shapes of
    their contracts, and raise outside them: no plain call."""
    g = _graph(100, 500, 5, cuda)
    spmm_cuda.reset_counts()
    gat_cuda.reset_counts()
    cuda_build.reset_counts()
    ops.edge_softmax(g, torch.zeros((g.n_edges, 2), device=cuda))
    ops.u_mul_e_sum(g, torch.zeros((100, 3), device=cuda),
                    torch.zeros(g.n_edges, device=cuda))
    ops.gcn_norm_both(g, torch.zeros((100, 3), device=cuda),
                      torch.ones(g.n_edges, device=cuda))
    assert gat_cuda.counts["edge_softmax_fwd"] == 1
    assert spmm_cuda.counts["spmm_csr_weighted"] == 2
    with pytest.raises(ValueError, match="edge_softmax kernel"):
        ops.edge_softmax(g, torch.zeros((g.n_edges, 2, 2), device=cuda))
    with pytest.raises(ValueError, match="weighted SpMM kernel"):
        ops.u_mul_e_sum(g, torch.zeros((100, 3), device=cuda),
                        torch.zeros((g.n_edges, 3), device=cuda))
    assert cuda_build.counts == {"plain_on_cuda": 0}


def _weighted_matches_plain(g, heads, d, zero_rows):
    cuda = g.device
    h = heads or 1
    x = torch.randn((g.n_nodes, h * d), device=cuda)
    for w in (torch.rand((g.n_edges, h), device=cuda),
              (torch.rand((g.n_edges, h), device=cuda) >= 0.5).float() * 2):
        w = w[:, 0].contiguous() if heads is None else w
        for args in ((g.indptr, g.senders, None),
                     (g.t_indptr, g.t_receivers, g.t_edges)):
            got = spmm_cuda.csr_wsum_bf16(*args, x, w, g.n_nodes)
            want = spmm_cuda.plain_csr_wsum_bf16(*args, x, w, g.n_nodes)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        got = spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, x, w,
                                      g.n_nodes)
        assert got[zero_rows].abs().max().item() == 0.0


@pytest.mark.parametrize("heads,d", WEIGHTED_SHAPES)
def test_weighted_kernel_matches_plain(cuda, heads, d):
    """Forward walk and transposed walk (weights read through t_edges), with
    zero in-degree rows; odd and narrow widths."""
    _weighted_matches_plain(
        _graph(500, 6000, 7 * d + (heads or 0), cuda, hub_free=20), heads, d,
        slice(0, 20))


@pytest.mark.parametrize("heads,d", WEIGHTED_SHAPES)
def test_weighted_kernel_matches_plain_on_hub_rows(cuda, heads, d):
    _weighted_matches_plain(
        _hub_graph(HUB_NODES, 6000, 7 * d + (heads or 0), cuda), heads, d,
        slice(0, 1))


@pytest.mark.parametrize("heads", [None, 4])
def test_weighted_gradient_matches_plain(cuda, heads):
    g = _graph(400, 5000, 8, cuda)
    shape = (g.n_nodes, 24) if heads is None else (g.n_nodes, heads, 6)
    x = torch.randn(shape, device=cuda, requires_grad=True)
    w = torch.rand((g.n_edges,) if heads is None else (g.n_edges, heads),
                   device=cuda, requires_grad=True)
    dh = torch.randn(shape, device=cuda)
    spmm_cuda.reset_counts()
    dx, dw = torch.autograd.grad(spmm_cuda.u_mul_e_sum(g, x, w), (x, w), dh)
    assert spmm_cuda.counts["spmm_csr_weighted"] == 2
    n = g.n_nodes
    want_dx = spmm_cuda.plain_csr_wsum_bf16(
        g.t_indptr, g.t_receivers, g.t_edges, dh.reshape(n, -1), w.detach(),
        n).view(shape)
    want_dw = (x.detach()[g.senders.long()] * dh[g.receivers.long()]).sum(-1)
    torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-4)


def _softmax_matches_plain(g, heads):
    cuda = g.device
    shape = (g.n_edges,) if heads is None else (g.n_edges, heads)
    s = (3 * torch.randn(shape, device=cuda)).requires_grad_(True)
    da = torch.randn(shape, device=cuda)
    gat_cuda.reset_counts()
    alpha = gat_cuda.edge_softmax(g, s)
    (ds,) = torch.autograd.grad(alpha, s, da)
    assert gat_cuda.counts["edge_softmax_fwd"] == 1
    assert gat_cuda.counts["edge_softmax_bwd"] == 1
    assert alpha.shape == shape
    s2 = s.detach().reshape(g.n_edges, -1)
    want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s2, g.n_nodes)
    want_ds = gat_cuda.plain_edge_softmax_bwd(
        g.indptr, want, da.reshape(g.n_edges, -1), g.n_nodes)
    torch.cuda.synchronize()
    torch.testing.assert_close(alpha.reshape(want.shape), want, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(ds.reshape(want.shape), want_ds, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("heads", SOFTMAX_HEADS)
def test_edge_softmax_kernels_match_plain(cuda, heads):
    """1-D scores, one head, heads that do not divide 32 and more heads
    than lanes; zero in-degree rows own no score."""
    _softmax_matches_plain(_graph(600, 7000, 9 + (heads or 0), cuda,
                                  hub_free=25), heads)


@pytest.mark.parametrize("heads", SOFTMAX_HEADS)
def test_edge_softmax_kernels_match_plain_on_hub_rows(cuda, heads):
    _softmax_matches_plain(
        _hub_graph(HUB_NODES, 7000, 9 + (heads or 0), cuda), heads)
