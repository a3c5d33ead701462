"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no CUDA device is present. Run on a
GPU machine with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the suite's conftest imports JAX, which the port
does not need). Tolerances: the exact SpMM kernel and its plain version
differ only in summation order (rtol 1e-5, atol 1e-4), and so do the f32
kernel (feature_prop's hops) and its plain version; int8 sums are exact
(bit-equal). The GAT kernels differ from their plain versions in summation
order and in the order of their f32 operations (the forward multiplies
by one reciprocal of the denominator): f32 outputs at rtol 1e-4 / atol
1e-4 x max; the bf16 message by at most one bf16 ulp (rtol 2**-7), since a
last-bit f32 difference can round either way; the segment max is exact.
In seed mode the kernels generate the dropout bits that `philox_keep`
gives, so they are bit-equal to the mask mode fed that mask. `gat_prep`
writes the bf16 features bit for bit, el up to its summation order (rtol
1e-6 / atol 1e-6 x max) and er within one bf16 ulp. The
weighted SpMM rounds the same f32 products as its plain version and
differs in summation order only (rtol 1e-5, atol 1e-4); the segment
softmax differs in the order of its f32 sums (rtol 1e-5 forward, 1e-4 for
the gradient, as tests/test_pallas.py:368,421).

Every kernel walks a dst row's edges in chunks of 32, so each kernel test
also runs on a hub graph (`_hub_graph`) whose first rows have the in- and
out-degrees HUB_DEGREES: empty, one edge, either side of one and of two
chunks, and rows of about a thousand and twenty thousand edges. The f32
kernel splits rows of more than T = spmm_cuda.F32_CHUNK edges across
warps, so its tests also take rows of T - 1, T, T + 1 and 3T + 5 edges
(SPLIT_DEGREES), and a second launch must be bit-equal to the first (no
atomics: its order of summation is fixed by the graph and the layout).
The template body (bf16, int8, weighted) and gat_fwd split rows of more
than T = spmm_cuda.HUB_CHUNK edges as well: on rows of T - 1, T, T + 1
and 20 T edges (hub_walks.HUB_SPLIT) the template kernels equal their
numpy walk (tests/hub_walks.py) bit for bit (the weighted walk with half
its weights 0 too: it gathers only the kept edges of each 32-edge
window), and gat_fwd its torch walk
to 1e-5 (the walk's exponentials and products are the CPU's). gat_bwd and
edge_softmax_fwd split the same rows (three launches each on such a CSR),
and edge_softmax_bwd (two launches), each held to its walk at 1e-5 and to
its plain version at the tolerances above, two launches bit-equal. The
GAT kernels' split tests run at T = spmm_cuda.HUB_CHUNK and at the GAT
layer's T = gat_cuda.GAT_CHUNK (rows either side of each).
"""

import collections
import functools
import json

import numpy as np
import pytest
import torch

import hub_walks
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import (cuda_build, gat_cuda, graph_utils, refops,
                                spmm_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


HUB_DEGREES = (0, 1, 31, 32, 33, 64, 65, 1000, 20000)
HUB_NODES = 25000
SPMM_WIDTHS = [1, 7, 40, 64, 100, 128, 256, 300]
GAT_SHAPES = [(8, 16), (1, 40), (2, 7), (3, 5), (12, 4)]
WEIGHTED_SHAPES = [(None, 1), (None, 7), (None, 40), (None, 64), (None, 100),
                   (None, 128), (8, 16), (1, 40), (3, 5), (2, 7)]
SOFTMAX_HEADS = [None, 1, 3, 8, 32, 40]


def _graph(n, e, seed, device, hub_free=0):
    """Random graph whose first `hub_free` nodes receive no edges."""
    rs = np.random.RandomState(seed)
    return build_graph(rs.randint(0, n, e), rs.randint(hub_free, n, e),
                       n).to(device)


def _hub_graph(n, e, seed, device, degrees=HUB_DEGREES):
    """Random graph whose node i < len(degrees) has exactly degrees[i]
    in-edges and as many out-edges (so the transposed walk meets the same
    rows), from and to distinct other nodes as in a graph without
    multi-edges, so n must exceed max(degrees); the other e edges join the
    remaining nodes uniformly. Node 0 is the zero-degree row."""
    rs = np.random.RandomState(seed)
    k = len(degrees)
    hubs = np.repeat(np.arange(k), degrees)
    ends = [np.concatenate([rs.choice(np.arange(k, n), d, replace=False)
                            for d in degrees]) for _ in range(2)]
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


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("f", [100, 7, 2])
def test_dataset_widths_match_plain(cuda, f, hub):
    """The widths the dataset paths give the SpMM (SAGE layer 1 on
    ogbn-products, GCN layer 2 on cora and on penn94), each with its own
    lane layout: both tiers' forward, and the backward through both
    autograd.Functions, on a random and on a hub graph."""
    if hub:
        g, zero_rows = _hub_graph(HUB_NODES, 6000, f, cuda), slice(0, 1)
    else:
        g, zero_rows = _graph(500, 6000, f, cuda, hub_free=20), slice(0, 20)
    _spmm_matches_plain(g, f, zero_rows)
    x = torch.randn((g.n_nodes, f), device=cuda, requires_grad=True)
    dh = torch.randn((g.n_nodes, f), device=cuda)
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
    graph_utils.feature_prop(x, g, 2)
    assert spmm_cuda.counts == {"spmm_csr_bf16": 1, "spmm_csr_int8": 1,
                                "spmm_csr_weighted": 1, "spmm_csr_f32": 2}
    assert cuda_build.counts == {"plain_on_cuda": 0}


def _f32_matches_plain(g, f, zero_rows, x=None):
    """Both walks against the plain version, each element within 1e-5 of
    its row's magnitude; a second launch bit-equal to the first."""
    if x is None:
        x = torch.randn((g.n_nodes, f), device=g.device)
    for indptr, cols in ((g.indptr, g.senders), (g.t_indptr, g.t_receivers)):
        got = spmm_cuda.csr_sum_f32(indptr, cols, x, g.n_nodes)
        again = spmm_cuda.csr_sum_f32(indptr, cols, x, g.n_nodes)
        want = refops.csr_sum_f32(indptr, cols, x, g.n_nodes)
        magnitude = refops.csr_sum_f32(indptr, cols, x.abs(), g.n_nodes)
        assert bool(((got - want).abs() <= 1e-5 * magnitude).all())
        assert torch.equal(got, again)
        if indptr is g.indptr:
            assert got[zero_rows].abs().max().item() == 0.0


@pytest.mark.parametrize("f", SPMM_WIDTHS)
def test_f32_kernel_matches_plain(cuda, f):
    """spmm_csr_f32 (feature_prop's hops) against refops.csr_sum_f32: f32
    rows summed in f32 in another order, so each element within 1e-5 of
    its row's magnitude (the sum of |x| over the row's edges). A fixed
    rtol does not fit: on a 20,000-edge row the two orders differ by
    about 1e-3 on sums of about 100 (measured on an H100)."""
    _f32_matches_plain(_graph(500, 6000, f, cuda, hub_free=20), f,
                       slice(0, 20))
    _f32_matches_plain(_hub_graph(HUB_NODES, 6000, f, cuda), f, slice(0, 1))


T = spmm_cuda.F32_CHUNK
SPLIT_DEGREES = (0, 1, T - 1, T, T + 1, 3 * T + 5, 1000, 20000)


@pytest.mark.parametrize("f", SPMM_WIDTHS)
def test_f32_kernel_on_split_rows(cuda, f):
    """Rows either side of the chunk length T, split into chunks of T
    edges whose partials the second kernel sums in chunk order: both
    walks against the plain version, two launches bit-equal; the plan
    lists exactly the rows of more than T edges."""
    g = _hub_graph(HUB_NODES, 6000, f + 1, cuda, SPLIT_DEGREES)
    plan = spmm_cuda.hub_plan(g.indptr, g.n_nodes, spmm_cuda.F32_CHUNK)
    deg = (g.indptr[1:g.n_nodes + 1] - g.indptr[:g.n_nodes]).cpu()
    assert plan.rows.tolist() == torch.nonzero(deg > T).flatten().tolist()
    assert plan.n_chunks == sum(-(-d // T) for d in SPLIT_DEGREES if d > T)
    _f32_matches_plain(g, f, slice(0, 1))


@pytest.mark.parametrize("f", [100, 128, 7])
def test_f32_kernel_on_misaligned_x(cuda, f):
    """x whose base is 4 bytes past a 16-byte boundary takes the kernel's
    4-byte copies, never the plain version."""
    g = _hub_graph(HUB_NODES, 6000, f, cuda, SPLIT_DEGREES)
    buf = torch.randn(g.n_nodes * f + 1, device=cuda)
    x = buf[1:].view(g.n_nodes, f)
    assert spmm_cuda.f32_geometry(f, align=x.data_ptr()).vec == 1
    cuda_build.reset_counts()
    _f32_matches_plain(g, f, slice(0, 1), x)
    assert cuda_build.counts["plain_on_cuda"] == 4   # the checks' own


def test_f32_counts_both_passes_and_keeps_the_plan(cuda):
    """A graph with split rows launches both kernels per hop (two counts),
    feature_prop builds its graph's plan once and gives the same hops, bit
    for bit, as the wrapper that makes a plan per call; nothing runs plain.
    (Each hop is held against the plain version by
    test_f32_kernel_on_split_rows.)"""
    g = _hub_graph(HUB_NODES, 6000, 8, cuda, SPLIT_DEGREES)
    x = torch.randn((g.n_nodes, 128), device=cuda)
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    got = graph_utils.feature_prop(x, g, 2)
    plan = spmm_cuda.graph_f32_plan(g)
    assert spmm_cuda.graph_f32_plan(g) is plan and plan.n_chunks > 0
    assert spmm_cuda.counts["spmm_csr_f32"] == 4
    assert cuda_build.counts == {"plain_on_cuda": 0}
    # the same hops through the wrapper without the kept plan: bit-equal
    norm = torch.rsqrt(g.in_degrees.clamp(min=1.0))[:, None]
    want = x
    for _ in range(2):
        want = spmm_cuda.csr_sum_f32(g.indptr, g.senders, want * norm,
                                     g.n_nodes) * norm
    assert torch.equal(got, want)
    assert g.to(cuda).cache == {}                  # a moved graph's own


# ---- hub rows split across warps: the template body and gat_fwd ----------

HT = spmm_cuda.HUB_CHUNK
GT = gat_cuda.GAT_CHUNK


def _split_graph(seed, device, n_random=6000, chunk=HT):
    """Rows of 0, 1, T - 1, T, T + 1 and 20 T in- and out-edges among 3,000
    nodes (hub_walks.HUB_SPLIT at T = HUB_CHUNK), the rest random; T =
    `chunk`."""
    degrees = (0, 1, chunk - 1, chunk, chunk + 1, 20 * chunk)
    src, dst, n = hub_walks.hub_split_arrays(seed, degrees, n=3000,
                                             n_random=n_random)
    return build_graph(src, dst, n).to(device)


def _template_case(g, policy, f, heads, walk, compact=True):
    """(kernel call, plain call, mirror, magnitude) of one policy on one
    walk of g: the kernel with the walk's kept plan, the plain version,
    hub_walks.template_walk on the same inputs (`compact` as it takes it),
    and the plain version on |x| and |w| (each sum's magnitude). The
    policy "weighted-drop" is the weighted sum with about half the weights
    0, as APPNP's edge drop leaves them."""
    gen = torch.Generator(device=g.device).manual_seed(f * 7 + heads)
    n = g.n_nodes
    indptr, indices, widx, name = (
        (g.indptr, g.senders, None, "indptr") if walk == "forward"
        else (g.t_indptr, g.t_receivers, g.t_edges, "t_indptr"))
    plan = spmm_cuda.plan_of(g, name, n)
    ip, ix = indptr[:n + 1].cpu().numpy(), indices.cpu().numpy()
    x = torch.randn((n, f), generator=gen, device=g.device)
    if policy == "bf16":
        xb = spmm_cuda.to_message(x)

        def call(xb=xb):
            return spmm_cuda.csr_sum_bf16(indptr, indices, xb, n, plan)

        def plain(xb=xb):
            return spmm_cuda.plain_csr_sum_bf16(indptr, indices, xb, n)
        mirror = hub_walks.template_walk(
            ip, ix, xb.float().cpu().numpy(), n,
            spmm_cuda.geometry(f, 2, align=xb.data_ptr()), HT)
        mag = spmm_cuda.plain_csr_sum_bf16(indptr, indices, xb.abs(), n)
        return call, plain, mirror, mag
    if policy == "int8":
        q, sc = spmm_cuda.quantize_cols(x)

        def call():
            return spmm_cuda.csr_sum_int8(indptr, indices, q, sc, n, plan)

        def plain():
            return spmm_cuda.plain_csr_sum_int8(indptr, indices, q, sc, n)
        mirror = hub_walks.template_walk(
            ip, ix, q.cpu().numpy(), n,
            spmm_cuda.geometry(f, 1, align=q.data_ptr()), HT, "int8",
            scale=sc.cpu().numpy())
        return call, plain, mirror, None
    w = torch.rand((g.n_edges, heads), generator=gen, device=g.device) * 2
    w = w[:, 0] if heads == 1 else w
    if policy == "weighted-drop":
        w = torch.where(torch.rand(w.shape, generator=gen, device=g.device)
                        < 0.5, torch.zeros_like(w), w)

    def call():
        return spmm_cuda.csr_wsum_bf16(indptr, indices, widx, x, w, n, plan)

    def plain(x=x):
        return spmm_cuda.plain_csr_wsum_bf16(indptr, indices, widx, x, w, n)
    mirror = hub_walks.template_walk(
        ip, ix, x.cpu().numpy(), n,
        spmm_cuda.geometry(f, 4, f // heads, align=x.data_ptr()), HT,
        "weighted", w=w.cpu().numpy(),
        widx=None if widx is None else widx.cpu().numpy(), heads=heads,
        compact=compact)
    return call, plain, mirror, plain(x.abs())


@pytest.mark.parametrize("walk", ["forward", "transposed"])
@pytest.mark.parametrize("policy,f,heads", [
    ("bf16", 40, 1), ("bf16", 128, 1), ("bf16", 7, 1), ("bf16", 300, 1),
    ("int8", 40, 1), ("int8", 128, 1), ("int8", 300, 1),
    ("weighted", 40, 1), ("weighted", 128, 8), ("weighted", 15, 3),
    ("weighted-drop", 40, 1), ("weighted-drop", 7, 1)])
def test_template_split_kernels_equal_their_walk(cuda, policy, f, heads,
                                                 walk):
    """The template body with rows of more than T edges split (both
    launches counted): bit for bit equal to hub_walks.template_walk (the
    same f32 adds in the same order; with half the weights 0, the
    compacted windows' order), to a second launch, and to the plain
    version within 1e-5 of each sum's magnitude (int8: exactly)."""
    g = _split_graph(f + heads, cuda)
    call, plain, mirror, mag = _template_case(g, policy, f, heads, walk)
    name = f"spmm_csr_{policy.split('-')[0]}"
    spmm_cuda.reset_counts()
    got = call()
    again = call()
    assert spmm_cuda.counts[name] == 4               # two calls, two passes
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), torch.from_numpy(mirror))
    want = plain()
    if mag is None:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= 1e-5 * mag).all())
    assert got[len(hub_walks.HUB_SPLIT) - 1].abs().max() > 0


@pytest.mark.parametrize("walk", ["forward", "transposed"])
def test_dense_weights_keep_the_walk_order(cuda, walk):
    """With no weight of 0 the weighted walk gathers every edge in the
    order it took before it compacted windows: bit for bit equal to the
    mirror walking every edge, at F = 40 on split rows."""
    g = _split_graph(41, cuda)
    call, _, mirror, _ = _template_case(g, "weighted", 40, 1, walk,
                                        compact=False)
    assert torch.equal(call().cpu(), torch.from_numpy(mirror))


def test_gather_counts_count_the_kept_edges(cuda, monkeypatch):
    """While a profiler runs every weighted walk adds the edges it walked
    and the edges it gathered: with one weight per edge the nonzero ones
    (APPNP's hops, both walks, and the plain weighted sum), with several
    heads every edge. With no profiler nothing is counted; reset_counts
    zeroes both. (A running profiler is stood in for by `recording`: a
    short profiler session as a process's first one lost the kernels of
    later traces on the card. The traced APPNP epoch reads the counter
    under a real one, test_steady_appnp_epoch_builds_no_plan.)"""
    g = _split_graph(43, cuda)
    n, e = g.n_nodes, g.n_edges
    x, h0 = torch.randn(n, 40, device=cuda), torch.randn(n, 40, device=cuda)
    w = (torch.rand(e, device=cuda) >= 0.5).float() * 2
    w8 = torch.rand(e, 8, device=cuda) * (w[:, None] > 0)
    s, d = refops.degree_norms(g)
    kept = int((w != 0).sum())

    def walks():
        spmm_cuda.appnp_wsum(g, x, w, s, d, h0, APPNP_ALPHA, False)
        spmm_cuda.appnp_wsum(g, x, w, d, s, None, APPNP_ALPHA, True)
        spmm_cuda.u_mul_e_sum(g, x, w)
        spmm_cuda.u_mul_e_sum(g, x.view(n, 8, 5), w8)

    spmm_cuda.reset_counts()
    walks()
    assert spmm_cuda.gather_counts() == {"walked": 0, "gathered": 0}
    monkeypatch.setattr(spmm_cuda, "recording", lambda: True)
    walks()
    assert 0 < kept < e
    assert spmm_cuda.gather_counts() == {"walked": 4 * e,
                                         "gathered": 3 * kept + e}
    spmm_cuda.reset_counts()
    assert spmm_cuda.gather_counts() == {"walked": 0, "gathered": 0}


@pytest.mark.parametrize("chunk", [HT, GT])
@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_fwd_split_matches_walk_and_plain(cuda, h, d, drop, chunk):
    """gat_fwd with rows of more than T edges split (three launches): two
    launches bit-equal; the max bit for bit equal to the plain version's
    and to hub_walks.gat_fwd_walk's; out and den within the GAT
    tolerances of the plain version (den of the split rows, sums of up to
    10,240 terms in another order, within 1e-4 of itself) and within 1e-5
    of the walk (which differs in its exponentials and fused
    multiply-adds only). Seed mode: the kernels' own keep bits."""
    g = _split_graph(h * 10 + d, cuda, chunk=chunk)
    feat, al, ar, _ = _gat_inputs(g, h, d, 0.0, 3)
    keep = (torch.tensor([0x5EED0000 + h * d], dtype=torch.int64,
                         device=cuda) if drop else None)
    feat_b, el, er_b, _ = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep,
            1.0 / (1.0 - drop), 0.2)
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes, chunk)
    gat_cuda.reset_counts()
    got = gat_cuda.gat_fwd(*args, plan=plan)
    again = gat_cuda.gat_fwd(*args, plan=plan)
    assert gat_cuda.counts["gat_fwd"] == 6
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    short = (g.indptr[1:g.n_nodes + 1] - g.indptr[:g.n_nodes]) <= chunk
    walk = hub_walks.gat_fwd_walk(*(t.cpu() if torch.is_tensor(t) else t
                                    for t in args), chunk)
    want = gat_cuda.plain_gat_fwd(*args)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1].cpu(), walk[1])
    _close(got[0], want[0])
    _close(got[2][short], want[2][short], rtol=1e-5, scale=1e-6)
    torch.testing.assert_close(got[2][~short], want[2][~short], rtol=1e-4,
                               atol=0)
    _close(got[0].cpu(), walk[0], rtol=1e-5, scale=1e-5)
    torch.testing.assert_close(got[2].cpu(), walk[2], rtol=1e-5, atol=0)
    assert bool((got[2][~short] >= 1).all())


@pytest.mark.parametrize("chunk", [HT, GT])
@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_bwd_split_matches_walk_and_plain(cuda, h, d, drop, chunk):
    """gat_bwd with rows of more than T edges split (the chunks' parts of
    t, the walk, the split rows' der: three launches): two launches
    bit-equal; der, msg and dattn_l within 1e-5 of hub_walks.gat_bwd_walk
    (the message within a bf16 ulp) and within the GAT tolerances of the
    plain version. Seed mode: the kernels' own keep bits."""
    g = _split_graph(h * 10 + d + 1, cuda, chunk=chunk)
    feat, al, ar, _ = _gat_inputs(g, h, d, 0.0, 5)
    keep = (torch.tensor([0x5EED0000 + h * d], dtype=torch.int64,
                         device=cuda) if drop else None)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep,
            1.0 / (1.0 - drop), 0.2)
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes, chunk)
    assert plan.n_chunks > 0
    _, smax, denom = gat_cuda.gat_fwd(*args, plan=plan)
    dout = torch.randn_like(feat)
    gat_cuda.reset_counts()
    got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b, plan=plan)
    again = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b, plan=plan)
    assert gat_cuda.counts["gat_bwd"] == 6
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    walk = hub_walks.gat_bwd_walk(*(t.cpu() if torch.is_tensor(t) else t
                                    for t in args + (smax, denom, dout,
                                                     al_b)), chunk)
    want = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
    for other, rtol in ((want, 1e-4), (walk, 1e-5)):
        _close(got[0].cpu(), other[0].cpu(), rtol, rtol)
        _close(got[1].cpu(), other[1].cpu(), rtol=2.0 ** -7, scale=1e-5)
        _close(got[2].cpu(), other[2].cpu(), rtol, rtol)
    assert got[0][0].abs().max().item() == 0.0


@pytest.mark.parametrize("heads", [1, 3, 8, 40])
def test_edge_softmax_fwd_split_matches_walk_and_plain(cuda, heads):
    """edge_softmax_fwd with rows of more than T edges split (the chunks'
    maxima, their sums with the row's max, then alpha: three launches):
    two launches bit-equal, within 1e-5 of hub_walks.softmax_fwd_walk and
    of the plain version (atol 1e-6); every split row sums to 1."""
    g = _split_graph(heads + 40, cuda)
    s = 3 * torch.randn((g.n_edges, heads), device=cuda)
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes)
    gat_cuda.reset_counts()
    got = gat_cuda.edge_softmax_fwd(g.indptr, s, g.n_nodes, plan)
    again = gat_cuda.edge_softmax_fwd(g.indptr, s, g.n_nodes, plan)
    assert gat_cuda.counts["edge_softmax_fwd"] == 6
    assert torch.equal(got, again)
    walk = hub_walks.softmax_fwd_walk(g.indptr.cpu(), s.cpu(), g.n_nodes,
                                      HT)
    want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, g.n_nodes)
    torch.testing.assert_close(got.cpu(), walk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    split = g.receivers.long() == len(hub_walks.HUB_SPLIT) - 1
    torch.testing.assert_close(got[split].sum(0).cpu(), torch.ones(heads))


@pytest.mark.parametrize("heads", [1, 3, 8, 40])
def test_edge_softmax_bwd_split_matches_walk_and_plain(cuda, heads):
    """edge_softmax_bwd with rows of more than T edges split (the chunks'
    parts of t, then ds: two launches): two launches bit-equal, within
    1e-5 of hub_walks.softmax_bwd_walk and within the gradient's tolerance
    of the plain version (rtol 1e-4 / atol 1e-6)."""
    g = _split_graph(heads + 60, cuda)
    s = 3 * torch.randn((g.n_edges, heads), device=cuda)
    da = torch.randn((g.n_edges, heads), device=cuda)
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes)
    assert plan.n_chunks > 0
    alpha = gat_cuda.edge_softmax_fwd(g.indptr, s, g.n_nodes, plan)
    gat_cuda.reset_counts()
    got = gat_cuda.edge_softmax_bwd(g.indptr, alpha, da, g.n_nodes, plan)
    again = gat_cuda.edge_softmax_bwd(g.indptr, alpha, da, g.n_nodes, plan)
    assert gat_cuda.counts["edge_softmax_bwd"] == 4
    assert torch.equal(got, again)
    walk = hub_walks.softmax_bwd_walk(g.indptr.cpu(), alpha.cpu(), da.cpu(),
                                      g.n_nodes, HT)
    want = gat_cuda.plain_edge_softmax_bwd(g.indptr, alpha, da, g.n_nodes)
    torch.testing.assert_close(got.cpu(), walk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    split = g.receivers.long() == len(hub_walks.HUB_SPLIT) - 1
    assert got[split].abs().max().item() > 0


def test_edge_softmax_op_on_split_rows(cuda):
    """ops.edge_softmax forward and backward on a graph with split rows:
    the forward's three launches and the backward's two on the graph's
    kept plan, no plain call, no plan built past the first step; alpha and
    ds against the plain versions."""
    g = _split_graph(71, cuda)
    s = (3 * torch.randn((g.n_edges, 8), device=cuda)).requires_grad_(True)
    da = torch.randn((g.n_edges, 8), device=cuda)
    ops.edge_softmax(g, s)                       # builds the kept plan
    spmm_cuda.reset_counts()
    gat_cuda.reset_counts()
    cuda_build.reset_counts()
    alpha = ops.edge_softmax(g, s)
    (ds,) = torch.autograd.grad(alpha, s, da)
    assert (gat_cuda.counts["edge_softmax_fwd"],
            gat_cuda.counts["edge_softmax_bwd"]) == (3, 2)
    assert cuda_build.counts == {"plain_on_cuda": 0}
    assert spmm_cuda.builds["hub_plan"] == 0
    want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s.detach(), g.n_nodes)
    want_ds = gat_cuda.plain_edge_softmax_bwd(g.indptr, want, da, g.n_nodes)
    torch.testing.assert_close(alpha, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ds, want_ds, rtol=1e-4, atol=1e-6)


def test_hub_plans_kept_and_built_once(cuda):
    """Every walk of the Graph (copy_u_sum both tiers and its backward,
    u_mul_e_sum and its dX, the GAT layer's forward, backward and source
    reduce, the segment softmax forward and backward, feature_prop) takes
    the plans kept on it: three builds however many calls (the dst-sorted
    CSR at T = HUB_CHUNK and at the GAT layer's GAT_CHUNK, the transpose at
    HUB_CHUNK), and weighted_csr carries the two at HUB_CHUNK. A halo shard
    keeps its own, one per CSR; a moved Graph or shard starts anew."""
    from glnn_tpu_torch.distributed.halo import build_halo_graph, csr_part

    g = _split_graph(5, cuda)
    n = g.n_nodes
    x = torch.randn((n, 40), device=cuda, requires_grad=True)
    w = torch.rand(g.n_edges, device=cuda, requires_grad=True)
    feat, al, ar, _ = _gat_inputs(g, 8, 16, 0.0, 4)
    spmm_cuda.builds["hub_plan"] = 0
    for _ in range(2):
        for op in (spmm_cuda.copy_u_sum, spmm_cuda.copy_u_sum_int8):
            op(g, x).sum().backward()
        spmm_cuda.u_mul_e_sum(g, x, w).sum().backward()
        ops.gat_attention(g, feat.requires_grad_(True), al, ar).sum()\
            .backward()
        ops.edge_softmax(g, w[:, None].expand(-1, 4)).sum().backward()
        graph_utils.feature_prop(x.detach(), g, 2)
    assert spmm_cuda.builds["hub_plan"] == 3
    csr = spmm_cuda.weighted_csr(g)
    assert csr.plan is spmm_cuda.plan_of(g, "indptr", n)
    assert csr.t_plan is spmm_cuda.plan_of(g, "t_indptr", n)
    assert csr.plan.n_chunks > 0 and csr.t_plan.n_chunks > 0
    assert g.to(cuda).cache == {}

    src, dst = (t.cpu().numpy() for t in (g.senders, g.receivers))
    hg = build_halo_graph(src, dst, n, 1, combined=True)[0].to(cuda)
    spmm_cuda.builds["hub_plan"] = 0
    for _ in range(2):
        c = hg.combined_csr()
        for name, rows in (("indptr", hg.rows), ("t_indptr", hg.rows)):
            csr_part(True, hg, name, x.detach(), rows)
    assert spmm_cuda.builds["hub_plan"] == 4
    assert c.plan is hg.combined_csr().plan and c.plan.n_chunks > 0
    assert hg.to(cuda).cache == {}


def test_gat_layer_on_hub_rows_matches_plain_chain(cuda):
    """ops.gat_attention on a graph with split rows: gat_fwd's three
    launches, gat_bwd's three and the source reduce's two, no plain call;
    the forward and the gradients against the plain versions' chain."""
    g = _split_graph(13, cuda)
    feat, al, ar, _ = _gat_inputs(g, 4, 8, 0.0, 6)
    leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
    dout = torch.randn_like(feat)
    spmm_cuda.reset_counts()
    gat_cuda.reset_counts()
    cuda_build.reset_counts()
    out = ops.gat_attention(g, *leaves)
    out.backward(dout)
    assert (gat_cuda.counts["gat_fwd"], gat_cuda.counts["gat_bwd"]) == (3, 3)
    assert spmm_cuda.counts["spmm_csr_bf16"] == 2
    assert cuda_build.counts == {"plain_on_cuda": 0}
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, None, 1.0, 0.2)
    want_out, smax, denom = gat_cuda.plain_gat_fwd(*args)
    der, msg, dal = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
    dfeat = torch.zeros_like(feat).index_add_(0, g.senders, msg.float())
    dfeat += der[:, :, None] * ar[None]
    _close(out, want_out)
    _close(leaves[0].grad, dfeat, rtol=1e-2, scale=1e-2)
    _close(leaves[1].grad, dal, rtol=1e-3, scale=1e-3)
    _close(leaves[2].grad, torch.einsum("nh,nhd->hd", der, feat),
           rtol=1e-3, scale=1e-3)


def test_feature_prop_on_cuda_matches_cpu(cuda):
    g = _graph(400, 5000, 6, cuda)
    x = torch.randn((g.n_nodes, 128), device=cuda)
    got = graph_utils.feature_prop(x, g, 3)
    want = graph_utils.feature_prop(x.cpu(), g.to("cpu"), 3)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


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


def _gat_matches_plain(g, h, d, drop, zero_rows, mode="mask"):
    feat, al, ar, keep = _gat_inputs(g, h, d, drop, 1)
    inv_keep = 1.0 / (1.0 - drop)
    if drop and mode == "seed":
        keep = torch.tensor([0x5EED0000 + h * d], dtype=torch.int64,
                            device=g.device)
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


@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_kernels_seed_mode_match_plain(cuda, h, d):
    """Dropout generated in the kernels from a seed, against the plain
    versions applying philox_keep's mask; on a graph and on hub rows."""
    _gat_matches_plain(_graph(600, 7000, h * 10 + d, cuda, hub_free=25), h,
                       d, 0.3, slice(0, 25), mode="seed")
    _gat_matches_plain(_hub_graph(HUB_NODES, 7000, h * 10 + d, cuda), h, d,
                       0.3, slice(0, 1), mode="seed")


@pytest.mark.parametrize("h,d", GAT_SHAPES)
def test_gat_seed_mode_bit_equal_to_mask_mode(cuda, h, d):
    """Seed mode against mask mode fed philox_keep's mask on the device:
    the same arithmetic, so a single differing keep bit would show."""
    g = _hub_graph(HUB_NODES, 7000, h + d, cuda)
    feat, al, ar, _ = _gat_inputs(g, h, d, 0.0, 3)
    seed = torch.tensor([-0x123456789ABCDEF], dtype=torch.int64, device=cuda)
    mask = gat_cuda.philox_keep(seed, g.n_edges, h, 0.7)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    dout = torch.randn_like(feat)
    gat_cuda.reset_counts()
    got = []
    for keep in (seed, mask):
        args = (g.indptr, g.senders, feat_b, el, er_b, keep, 1 / 0.7, 0.2)
        out, smax, denom = gat_cuda.gat_fwd(*args)
        got.append((out, smax, denom)
                   + gat_cuda.gat_bwd(*args, smax, denom, dout, al_b))
    assert all(torch.equal(a, b) for a, b in zip(*got))
    for mode in gat_cuda.DROP_MODES:
        assert gat_cuda.counts[mode] == 1
    assert 0.69 < mask.float().mean().item() < 0.71


@pytest.mark.parametrize("base", [1, 123457, 2 ** 32 - 100])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_edge_base_bit_equal_to_based_mask(cuda, h, d, base):
    """Seed mode at an edge base (a shard's first global edge) against mask
    mode fed philox_keep's mask at that base, bit for bit, through both
    kernels; the base moves the bits (the counter wraps at 2**32)."""
    g = _hub_graph(HUB_NODES, 7000, h + d + 1, cuda)
    feat, al, ar, _ = _gat_inputs(g, h, d, 0.0, 5)
    seed = torch.tensor([0x0BA5E5EED], dtype=torch.int64, device=cuda)
    mask = gat_cuda.philox_keep(seed, g.n_edges, h, 0.7, base)
    assert not torch.equal(mask, gat_cuda.philox_keep(seed, g.n_edges, h,
                                                      0.7))
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    dout = torch.randn_like(feat)
    got = []
    for keep, edge_base in ((seed, base), (mask, 0)):
        args = (g.indptr, g.senders, feat_b, el, er_b, keep, 1 / 0.7, 0.2)
        out, smax, denom = gat_cuda.gat_fwd(*args, edge_base=edge_base)
        got.append((out, smax, denom) + gat_cuda.gat_bwd(
            *args, smax, denom, dout, al_b, edge_base))
    assert all(torch.equal(a, b) for a, b in zip(*got))


def _halo_gat_rank(m, payload):
    """On each of 2 ranks sharing the card: the fused halo GAT layer in
    seed mode, forward and one backward, on CUDA tensors (the kernels)
    and on CPU tensors (their plain versions); returns this rank's launch
    counts of the CUDA run."""
    from glnn_tpu_torch.distributed.halo import halo_gat_attention

    got = {}
    for dev in (m.device, torch.device("cpu")):
        hg = payload["hg"].to(dev)
        gen = torch.Generator().manual_seed(8)
        h, d, rows = 8, 16, hg.rows
        feat = torch.randn((hg.n_pad, h, d), generator=gen)
        al, ar = (0.3 * torch.randn((h, d), generator=gen) for _ in range(2))
        dout = torch.randn((hg.n_pad, h, d), generator=gen)
        mine = slice(m.rank * rows, (m.rank + 1) * rows)
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (feat[mine], al, ar)]
        seed = torch.tensor([0x5EED], dtype=torch.int64, device=dev)
        gat_cuda.reset_counts()
        spmm_cuda.reset_counts()
        cuda_build.reset_counts()
        out = halo_gat_attention(hg, *leaves, 0.2, seed, 1 / 0.7)
        out.backward(dout[mine].to(dev))
        got[dev.type] = [t.detach().cpu() for t in
                         [out] + [leaf.grad for leaf in leaves]]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = {**gat_cuda.counts, **spmm_cuda.counts,
                      **cuda_build.counts}
    (out, dfeat, dal, dar), want = got["cuda"], got["cpu"]
    _close(out, want[0])
    _close(dfeat, want[1], rtol=1e-2, scale=1e-2)
    _close(dal, want[2])
    _close(dar, want[3])
    return counts


def test_halo_gat_attention_two_shards_match_plain(cuda, monkeypatch):
    """Two ranks sharing the card over gloo: the fused halo GAT layer on the
    kernels (gat_prep, gat_fwd and gat_bwd in seed mode, the source
    reduce) against the same layer on CPU tensors, which runs the plain
    versions, at the GAT layer's bounds; no plain version on CUDA."""
    from glnn_tpu_torch.distributed import mesh
    from glnn_tpu_torch.distributed.halo import build_halo_graph

    monkeypatch.setenv(mesh.SHARE_DEVICE_ENV, "1")
    rs = np.random.RandomState(12)
    n, e = 3001, 40000
    shards = build_halo_graph(rs.randint(0, n, e), rs.randint(0, n, e), n, 2,
                              combined=True)
    counts = mesh.launch(_halo_gat_rank, [{"hg": s} for s in shards], 0,
                         timeout=300)
    want = dict.fromkeys(counts, 0)
    want.update(gat_prep=1, gat_fwd=1, gat_bwd=1, gat_fwd_seed=1,
                gat_bwd_seed=1, spmm_csr_bf16=1)
    assert counts == want


@pytest.mark.parametrize("h,d", GAT_SHAPES + [(4, 1024), (2, 100)])
def test_gat_prep_matches_plain(cuda, h, d):
    feat, al, ar, _ = _gat_inputs(_graph(3000, 10, h, cuda), h, d, 0.0, 4)
    gat_cuda.reset_counts()
    got = gat_cuda.prep(feat, al, ar)
    want = gat_cuda.plain_prep(feat, al, ar)
    torch.cuda.synchronize()
    assert gat_cuda.counts["gat_prep"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    _close(got[1], want[1], rtol=1e-6, scale=1e-6)
    _close(got[2], want[2], rtol=2.0 ** -7, scale=1e-6)


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
    assert gat_cuda.counts == {"gat_prep": 1, "gat_fwd": 1, "gat_bwd": 1,
                               "edge_softmax_fwd": 0, "edge_softmax_bwd": 0,
                               "gat_fwd_seed": 0, "gat_fwd_mask": 0,
                               "gat_bwd_seed": 0, "gat_bwd_mask": 0}
    assert spmm_cuda.counts == {"spmm_csr_bf16": 1, "spmm_csr_int8": 0,
                                "spmm_csr_weighted": 0, "spmm_csr_f32": 0}
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
    split = spmm_cuda.plan_of(g, "indptr", g.n_nodes).n_chunks > 0
    gat_cuda.reset_counts()
    alpha = gat_cuda.edge_softmax(g, s)
    (ds,) = torch.autograd.grad(alpha, s, da)
    # with split rows: the chunks' maxima and sums, then alpha
    assert gat_cuda.counts["edge_softmax_fwd"] == (3 if split else 1)
    # with split rows: the chunks' parts of t, then ds
    assert gat_cuda.counts["edge_softmax_bwd"] == (2 if split else 1)
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


def test_gat_layer_seed_mode_runs_no_mask(cuda):
    """ops.gat_attention with dropout on CUDA: both kernels in seed mode,
    the seed drawn from the generator on the device, and the gradient of
    the plain chain fed philox_keep's mask of that seed."""
    g = _graph(500, 6000, 12, cuda, hub_free=10)
    feat, al, ar, _ = _gat_inputs(g, 8, 16, 0.0, 5)
    leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
    dout = torch.randn_like(feat)
    gen = torch.Generator(device=cuda).manual_seed(3)
    seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                         generator=torch.Generator(device=cuda).manual_seed(3),
                         device=cuda)
    gat_cuda.reset_counts()
    cuda_build.reset_counts()
    ops.gat_attention(g, *leaves, drop_rate=0.3, gen=gen).backward(dout)
    assert gat_cuda.counts["gat_fwd_seed"] == 1
    assert gat_cuda.counts["gat_bwd_seed"] == 1
    assert gat_cuda.counts["gat_fwd_mask"] == gat_cuda.counts["gat_bwd_mask"] == 0
    assert cuda_build.counts == {"plain_on_cuda": 0}
    mask = gat_cuda.philox_keep(seed, g.n_edges, 8, 0.7)
    feat_b, el, er_b, al_b = gat_cuda.plain_prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, mask, 1 / 0.7, 0.2)
    _, smax, denom = gat_cuda.plain_gat_fwd(*args)
    der, msg, dal = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
    _close(leaves[1].grad, dal)
    _close(leaves[2].grad, torch.einsum("nh,nhd->hd", der, feat))


# -- the window sampler, dedup blocks and the bf16 compute tier ------------

# (method, window table, caps): Floyd, the window tier with and without the
# table, dedup with worst-case caps, and dedup with tight caps on the window
SAMPLER_CASES = [("floyd", False, None), ("window", True, None),
                 ("window", False, None), ("floyd", False, "worst"),
                 ("window", True, "tight"), ("window", False, "tight")]


@pytest.mark.parametrize("method,table,caps", SAMPLER_CASES)
def test_sampler_on_cuda_equals_cpu(cuda, method, table, caps):
    """The same uniforms through the sampler on the card and on the CPU,
    on the hub graph (rows of 65, 1,000 and 20,000 in-edges fold): every
    field of the blocks bit-equal."""
    from glnn_tpu_torch.sampling import frontier_caps, sample_blocks

    g = _hub_graph(HUB_NODES, 6000, 1, cuda)
    g = g.with_window_table() if table else g
    fanouts = [5, 10]
    seeds = torch.cat([torch.arange(len(HUB_DEGREES)),
                       torch.randint(0, HUB_NODES, (50,),
                                     generator=torch.Generator().manual_seed(4)),
                       torch.full((3,), HUB_NODES)]).to(torch.int32)
    cap_list = None
    sizes = [len(seeds) * (fanouts[1] + 1), len(seeds)]
    if caps is not None:
        cap_list = frontier_caps(len(seeds), fanouts, HUB_NODES)
        if caps == "tight":
            cap_list = [80, 40, len(seeds)]
        sizes = [cap_list[1] + 1, len(seeds)]
    gen = torch.Generator().manual_seed(5)
    uniforms = [torch.rand((c, f), generator=gen)
                for c, f in zip(sizes, fanouts)]
    got = sample_blocks(g, seeds.to(cuda), fanouts, uniforms=uniforms,
                        caps=cap_list, method=method)
    want = sample_blocks(g.to("cpu"), seeds, fanouts, uniforms=uniforms,
                         caps=cap_list, method=method)
    assert torch.equal(got.input_nodes.cpu(), want.input_nodes)
    for field in ("nbr_local", "valid", "self_local", "out_real"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            assert torch.equal(a.cpu(), b), field
    assert bool(got.overflowed) == bool(want.overflowed) == (caps == "tight")


@pytest.mark.parametrize("f", [128, 256])
def test_bf16_spmm_runs_both_kernels(cuda, f):
    """bf16 x on both tiers: the kernels launch, no plain version runs,
    the exact tier's bf16 output within one bf16 ulp of the plain version's
    f32 sum, the int8 tier's bit for bit (q and s from the same
    quantize_cols), and the backward in bf16 on the transposed walk."""
    g = _graph(500, 6000, f, cuda)
    x = torch.randn((g.n_nodes, f), device=cuda).bfloat16()
    dh = torch.randn((g.n_nodes, f), device=cuda).bfloat16()
    want = spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, x, g.n_nodes)
    q, s = spmm_cuda.quantize_cols(x)
    want_q = spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s,
                                          g.n_nodes).bfloat16()
    want_dx = spmm_cuda.plain_csr_sum_bf16(g.t_indptr, g.t_receivers, dh,
                                           g.n_nodes)
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    xg = x.clone().requires_grad_(True)
    out = spmm_cuda.copy_u_sum(g, xg)
    (dx,) = torch.autograd.grad(out, xg, dh)
    out_q = spmm_cuda.copy_u_sum_int8(g, x)
    assert spmm_cuda.counts == {"spmm_csr_bf16": 2, "spmm_csr_int8": 1,
                                "spmm_csr_weighted": 0, "spmm_csr_f32": 0}
    assert cuda_build.counts == {"plain_on_cuda": 0}
    assert out.dtype == out_q.dtype == dx.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want, rtol=2.0 ** -8, atol=1e-4)
    torch.testing.assert_close(dx.float(), want_dx, rtol=2.0 ** -8, atol=1e-4)
    assert torch.equal(out_q, want_q)


def test_bf16_sage_full_graph_eval_on_cuda_close_to_cpu(cuda):
    """A bf16 SAGE's exact eval on the card (the bf16 kernel, f32 sums)
    against the CPU plain tier (bf16 sums): log-probs within 3e-2 x max and
    argmax equal on 99% of rows."""
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import make_eval_fn

    conf = dict(model_name="SAGE", num_layers=3, hidden_dim=64, feat_dim=32,
                label_dim=5, dropout_ratio=0.0, norm_type="batch",
                compute_dtype="bfloat16")
    model = Model(conf, torch.Generator().manual_seed(0))
    g = _graph(500, 6000, 7, "cpu")
    x = torch.randn((g.n_nodes, 32), generator=torch.Generator().manual_seed(1))
    want = make_eval_fn(model, exact=True)(g, x)
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    got = make_eval_fn(model.to(cuda), exact=True)(g.to(cuda), x.to(cuda))
    assert spmm_cuda.counts["spmm_csr_bf16"] == 3
    assert cuda_build.counts == {"plain_on_cuda": 0}
    assert got.dtype == torch.float32
    got = got.cpu()
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    assert (got.argmax(1) == want.argmax(1)).float().mean() >= 0.99


def _rect_csr(n_rows, n_src, e, degrees, seed, device):
    """int32 CSR of n_rows rows over a source table of n_src rows: the first
    rows have in-degrees `degrees`, the other e edges fall on the rest."""
    rs = np.random.RandomState(seed)
    k = len(degrees)
    rows = np.concatenate([np.repeat(np.arange(k), degrees),
                           rs.randint(k, n_rows, e)])
    rows.sort(kind="stable")
    cols = rs.randint(0, n_src, rows.shape[0])
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return (torch.from_numpy(indptr.astype(np.int32)).to(device),
            torch.from_numpy(cols.astype(np.int32)).to(device))


@pytest.mark.parametrize("f", [40, 128, 256])
@pytest.mark.parametrize("n_rows,n_src", [(3000, 50000), (25000, 700)])
def test_exact_kernel_on_rectangular_csr(cuda, f, n_rows, n_src):
    """A halo partial: n_rows dst rows over a source table of another height
    (a receive buffer), with rows of 1,000 and 20,000 edges."""
    indptr, cols = _rect_csr(n_rows, n_src, 8000, (0, 1, 33, 1000, 20000),
                             f, cuda)
    xb = torch.randn((n_src, f), device=cuda).to(torch.bfloat16)
    got = spmm_cuda.csr_sum_bf16(indptr, cols, xb, n_rows)
    want = spmm_cuda.plain_csr_sum_bf16(indptr, cols, xb, n_rows)
    assert got.shape == (n_rows, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_halo_copy_u_sum_one_shard_runs_the_kernel(cuda, tmp_path):
    """P = 1 (a process group of one): the halo sum and its gradient on the
    exact kernel equal the single-device exact tier's, with no plain
    version on CUDA."""
    import torch.distributed as dist

    from glnn_tpu_torch.distributed.halo import (build_halo_graph,
                                                 halo_copy_u_sum)

    rs = np.random.RandomState(4)
    n, e, f = 3000, 40000, 128
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    hg = build_halo_graph(src, dst, n, 1)[0].to(cuda)
    g = build_graph(src, dst, n).to(cuda)
    x = torch.randn((n, f), device=cuda, requires_grad=True)
    co = torch.randn((n, f), device=cuda)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        cuda_build.reset_counts()
        spmm_cuda.reset_counts()
        out = halo_copy_u_sum(hg, x)
        (out * co).sum().backward()
        # the local and the (edge-free) halo partial, and the local
        # transpose: a receive buffer of no rows takes no call
        assert spmm_cuda.counts["spmm_csr_bf16"] == 3
        assert cuda_build.counts["plain_on_cuda"] == 0
    finally:
        dist.destroy_process_group()
    grad = x.grad.clone()
    x.grad = None
    want = spmm_cuda.copy_u_sum(g, x)
    (want * co).sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(grad, x.grad, rtol=1e-5, atol=1e-4)


def test_trace_counts_both_f32_passes(cuda, tmp_path):
    """On a graph with split rows both f32 kernels are reported as
    spmm_csr_f32, as often as the counter moved over the traced call."""
    from glnn_tpu_torch.utils.trace_report import trace_and_report

    g = _hub_graph(HUB_NODES, 6000, 9, cuda, SPLIT_DEGREES)
    x = torch.randn((g.n_nodes, 100), device=cuda)
    plan = spmm_cuda.graph_f32_plan(g)

    def run():
        spmm_cuda.csr_sum_f32(g.indptr, g.senders, x, g.n_nodes, plan)
        torch.cuda.synchronize()

    spmm_cuda.reset_counts()
    res = trace_and_report(run, cuda, iters=2, out_dir=tmp_path, quiet=True)
    got = {r.name: r.count for r in res["rows"]}
    assert spmm_cuda.counts["spmm_csr_f32"] == 6      # 3 calls, 2 passes
    assert got["spmm_csr_f32"] == 4


PORT_KERNELS = ("spmm_csr_bf16", "spmm_csr_int8", "spmm_csr_weighted",
                "spmm_csr_f32", "gat_prep", "gat_fwd", "gat_bwd",
                "edge_softmax_fwd", "edge_softmax_bwd")


def test_trace_report_names_each_kernel_once(cuda, tmp_path):
    """One launch of each of the nine kernels under trace_and_report: each
    is reported under the port's name with count 1, and no kernel of the
    trace is dropped."""
    import json

    from glnn_tpu_torch.utils.trace_report import trace_and_report

    g = _graph(500, 6000, 5, cuda)
    x = torch.randn((g.n_nodes, 32), device=cuda)
    xb = spmm_cuda.to_message(x)
    q, s = spmm_cuda.quantize_cols(x)
    w = torch.rand(g.n_edges, device=cuda)
    feat, al, ar, _ = _gat_inputs(g, 8, 16, 0.0, 2)
    dout = torch.randn_like(feat)
    scores = torch.randn((g.n_edges, 8), device=cuda)

    def run():
        spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, g.n_nodes)
        spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, g.n_nodes)
        spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, x, w, g.n_nodes)
        spmm_cuda.csr_sum_f32(g.indptr, g.senders, x, g.n_nodes)
        feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
        args = (g.indptr, g.senders, feat_b, el, er_b, None, 1.0, 0.2)
        _, smax, denom = gat_cuda.gat_fwd(*args)
        gat_cuda.gat_bwd(*args, smax, denom, dout, al_b)
        alpha = gat_cuda.edge_softmax_fwd(g.indptr, scores, g.n_nodes)
        gat_cuda.edge_softmax_bwd(g.indptr, alpha, scores, g.n_nodes)
        torch.cuda.synchronize()

    spmm_cuda.reset_counts()
    gat_cuda.reset_counts()
    res = trace_and_report(run, cuda, iters=1, out_dir=tmp_path, quiet=True)
    with open(res["path"]) as f:
        raw = sorted({e["name"] for e in json.load(f)["traceEvents"]
                      if e.get("cat", "").lower() == "kernel"})
    got = {r.name: r.count for r in res["rows"]}
    # the warm call outside the trace, then the traced one
    launched = {**spmm_cuda.counts, **gat_cuda.counts}
    assert all(got.get(k) == 1 and launched[k] == 2
               for k in PORT_KERNELS), (got, raw)
    assert sum(r.count for r in res["rows"]) >= len(raw)
    assert res["device"] == "cuda" and 0.0 <= res["idle_share"] < 1.0
    assert 0.0 < res["busy_ms"] <= res["window_ms"]


# ---- the program's spans on the card ----------------------------------------

def _power_law_graph(n, e, seed, device):
    """In-degrees by Redner's citation law (rank r draws a share (r - 1/2)
    ** -1/2 of the e edges, sources uniform), with reverse edges and
    self-loops: rows of some hundreds of edges, past the GAT plan's T."""
    rs = np.random.RandomState(seed)
    share = (np.arange(1, n + 1) - 0.5) ** -0.5
    dst = rs.choice(n, e, p=share / share.sum())
    src = rs.randint(0, n, e)
    loops = np.arange(n)
    return build_graph(np.concatenate([src, dst, loops]),
                       np.concatenate([dst, src, loops]), n).to(device)


def _traced_gat_epoch(device, tmp_path):
    """A steady full-batch GAT epoch (train step, eval, metrics row) on the
    power-law graph under the profiler, after a warm one: (span records,
    the Chrome trace's events, the graph)."""
    import logging

    from glnn_tpu_torch.nn.models import Model
    from glnn_tpu_torch.train import engine
    from glnn_tpu_torch.train.state import make_adam
    from glnn_tpu_torch.utils import profiling

    g = _power_law_graph(20000, 120000, 3, device)
    torch.manual_seed(3)
    conf = {"model_name": "GAT", "num_layers": 2, "hidden_dim": 64,
            "feat_dim": 32, "label_dim": 5, "dropout_ratio": 0.6,
            "num_heads": 8, "attn_dropout_ratio": 0.3}
    model = Model(conf).to(device)
    opt = make_adam(model.parameters(), 0.01, 0.01)
    feats = torch.randn(g.n_nodes, 32, device=device)
    labels = torch.randint(0, 5, (g.n_nodes,), device=device)
    idx = torch.randperm(g.n_nodes, device=device).view(4, -1)[:3]
    gen = torch.Generator(device=device).manual_seed(3)
    train = engine._teacher_epoch_fn(conf, model, opt, logging.getLogger(),
                                     g, feats, labels, idx[0], gen)
    evaluate = engine.make_eval_fn(model)

    def epoch(i):
        train(i)
        out = evaluate(g, feats)
        engine._metrics_row((out, labels, ix) for ix in idx)

    epoch(1)
    profiling.clear_spans()
    with profiling.trace(tmp_path, device) as t:
        epoch(2)
    recs = profiling.span_records()
    profiling.clear_spans()
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    return recs, events, g


def test_steady_gat_epoch_spans_build_no_plan_and_cross_threads(cuda,
                                                                 tmp_path):
    """No hub plan is built in a steady epoch; the backward's kernel spans
    run on autograd's device thread under the root of the epoch that
    waits in `loss.backward()`."""
    recs, _, g = _traced_gat_epoch(cuda, tmp_path)
    assert spmm_cuda.plan_of(g, "indptr", g.n_nodes,
                             gat_cuda.GAT_CHUNK).n_chunks > 0
    names = {r.name for r in recs}
    assert "plan.hub_plan" not in names
    assert {"runner.train_epoch", "runner.backward", "kernel.gat_fwd",
            "kernel.gat_bwd", "runner.eval", "runner.metrics_row"} <= names
    epoch, = [r for r in recs if r.name == "runner.train_epoch"]
    bwd = [r for r in recs if r.name == "kernel.gat_bwd"]
    assert len(bwd) == 2
    for r in bwd:
        assert r.thread != epoch.thread and r.parent == -1
        assert r.root == epoch.id
        assert epoch.start_ns <= r.start_ns <= r.end_ns <= epoch.end_ns
    assert sum(r.name == "runner.host_read" for r in recs) == 7


def test_gat_fwd_annotations_cover_its_kernels(cuda, tmp_path):
    """In the Chrome trace each `kernel.gat_fwd` span's device annotation
    (`gpu_user_annotation`) covers the gat_fwd kernels it launched, the
    hub passes included; every gat_fwd kernel lies in one."""
    from glnn_tpu_torch.utils.trace_report import port_name

    _, events, _ = _traced_gat_epoch(cuda, tmp_path)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "gpu_user_annotation"
             and e.get("name") == "kernel.gat_fwd"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"
               and port_name(e.get("name", "")) == "gat_fwd"]
    # two layers in the train step and two in the eval, three launches
    # each on split rows
    assert len(spans) == 4 and len(kernels) == 12
    slack = 1.0                                   # us: the trace's rounding
    for lo, hi in spans:
        inside = [k for k in kernels
                  if lo - slack <= k[0] and k[1] <= hi + slack]
        assert len(inside) == 3


def _traced_appnp_epoch(device, tmp_path):
    """A steady full-batch APPNP epoch (train step, int8 eval, metrics row)
    at ogbn-arxiv's shape (169,343 nodes, 1,166,243 citations by Redner's
    law: rows past HUB_CHUNK in both walks) under the profiler, after a
    warm one: (span records, the Chrome trace's events, the graph, the
    launches, hub plan builds, APPNP hops by path and the weighted walks'
    gather counts of the traced epoch)."""
    import logging

    from glnn_tpu_torch.nn.models import Model
    from glnn_tpu_torch.train import engine
    from glnn_tpu_torch.train.state import make_adam
    from glnn_tpu_torch.utils import profiling

    g = _power_law_graph(169343, 1166243, 21, device)
    torch.manual_seed(21)
    conf = {"model_name": "APPNP", "num_layers": 2, "hidden_dim": 128,
            "feat_dim": 128, "label_dim": 40, "dropout_ratio": 0.5}
    model = Model(conf).to(device)
    opt = make_adam(model.parameters(), 0.01, 0.01)
    feats = torch.randn(g.n_nodes, 128, device=device)
    labels = torch.randint(0, 40, (g.n_nodes,), device=device)
    idx = torch.randperm(g.n_nodes, device=device)[:3 * 40000].view(3, -1)
    gen = torch.Generator(device=device).manual_seed(21)
    train = engine._teacher_epoch_fn(conf, model, opt, logging.getLogger(),
                                     g, feats, labels, idx[0], gen)
    evaluate = engine.make_eval_fn(model)

    def epoch(i):
        train(i)
        out = evaluate(g, feats)
        engine._metrics_row((out, labels, ix) for ix in idx)

    epoch(1)
    torch.cuda.synchronize(device)
    before = (dict(spmm_cuda.counts), spmm_cuda.builds["hub_plan"],
              dict(ops.hop_counts), spmm_cuda.gather_counts())
    profiling.clear_spans()
    with profiling.trace(tmp_path, device) as t:
        epoch(2)
    recs = profiling.span_records()
    profiling.clear_spans()
    launches = {k: v - before[0][k] for k, v in spmm_cuda.counts.items()}
    hops = {k: v - before[2][k] for k, v in ops.hop_counts.items()}
    gathers = {k: v - before[3][k]
               for k, v in spmm_cuda.gather_counts().items()}
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    return (recs, events, g, launches,
            spmm_cuda.builds["hub_plan"] - before[1], hops, gathers)


def test_steady_appnp_epoch_builds_no_plan(cuda, tmp_path):
    """On a skewed graph at ogbn-arxiv's shape a steady APPNP epoch builds
    no hub plan: its 10 weighted hops (one mask draw each), their 10
    transposed walks and the eval's 10 int8 hops take the plans kept on
    the Graph, each two launches (walk and combine), all on the fused
    hop path; the 20 weighted walks gather the edges their edge drop
    keeps, about half."""
    recs, _, g, launches, built, hops, gathers = _traced_appnp_epoch(
        cuda, tmp_path)
    n = g.n_nodes
    assert spmm_cuda.plan_of(g, "indptr", n).n_chunks > 0
    assert spmm_cuda.plan_of(g, "t_indptr", n).n_chunks > 0
    assert built == 0
    assert "plan.hub_plan" not in {r.name for r in recs}
    assert launches == {"spmm_csr_bf16": 0, "spmm_csr_int8": 20,
                        "spmm_csr_weighted": 40, "spmm_csr_f32": 0}
    assert hops == {"fused_weighted": 10, "fused_int8": 10, "composed": 0}
    assert sum(r.name == "model.APPNP.edge_drop" for r in recs) == 10
    assert gathers["walked"] == 20 * g.n_edges
    assert 0.49 < gathers["gathered"] / gathers["walked"] < 0.51


def test_steady_appnp_epoch_launches_at_most_330_kernels(cuda, tmp_path):
    """With each hop's norms and teleport inside its walk, a steady APPNP
    epoch (train step, int8 eval, metrics row) launches at most 330
    kernels in all (510 when every hop was composed of torch ops)."""
    _, events, *_ = _traced_appnp_epoch(cuda, tmp_path)
    kernels = [e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    assert 60 <= len(kernels) <= 330, len(kernels)


def test_fused_hop_kernels_keep_the_benchmark_names(cuda, tmp_path):
    """The benchmark's trace (`gnnbench.trace.port_name`) maps every
    launch of the template body, the fused hops' included, to its
    policy's name: 40 weighted (20 of them transposed) and 20 int8."""
    from gnnbench.trace import port_name

    _, events, *_ = _traced_appnp_epoch(cuda, tmp_path)
    names = [e["name"] for e in events
             if e.get("cat") == "kernel" and e.get("ph") == "X"
             and "spmm_csr_" in e.get("name", "")]
    fused = [n for n in names if "Appnp<" in n]
    assert len(names) == len(fused) == 60
    ported = collections.Counter(port_name(n) for n in names)
    assert ported == {"spmm_csr_weighted": 40, "spmm_csr_int8": 20}


def test_device_annotation_follows_only_direct_launches(cuda, tmp_path):
    """The profiler gives a span a device annotation (`gpu_user_annotation`)
    over the kernels launched while it is the innermost span open, and
    only those: a span whose every kernel is launched inside a nested span
    gets none, a span with one direct launch gets one."""
    from glnn_tpu_torch.utils import profiling

    x = torch.ones(1 << 16, device=cuda)
    outer, direct = profiling.span("test.outer"), profiling.span("test.direct")
    inner = profiling.span("test.inner")
    torch.cuda.synchronize(cuda)
    profiling.clear_spans()
    with profiling.trace(tmp_path, cuda) as t:
        with outer:
            with inner:
                x.mul(2.0)
        with direct:
            x.add(1.0)
            with inner:
                x.mul(2.0)
    recs = profiling.span_records()
    profiling.clear_spans()
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    annotated = collections.Counter(
        e["name"] for e in events if e.get("cat") == "gpu_user_annotation"
        and e.get("name", "").startswith("test."))
    assert collections.Counter(r.name for r in recs) == {
        "test.outer": 1, "test.direct": 1, "test.inner": 2}
    assert annotated == {"test.inner": 2, "test.direct": 1}


def test_appnp_propagate_annotations_cover_the_hop_kernels(cuda, tmp_path):
    """In the Chrome trace every hop's kernels lie under the device
    annotation of their wrapper's span: the train step's 10 forward walks
    (`Appnp<0>`) and the backward's 10 transposed walks (`Appnp<1>`) under
    20 `kernel.spmm_csr_weighted` annotations, the eval's 10 int8 walks
    (`Appnp<2>`) under 10 `kernel.spmm_csr_int8` annotations, walk and
    combine of one pass in each, every forward one before every
    transposed one. `model.APPNP.propagate` has one device annotation, the
    eval's: it spans the kernels the eval's hops launch outside their
    wrapper's span (each hop's h * src_norm and quantisation), from the
    first hop's to the last hop's, so it covers the walks of hops 1-9
    (18 int8 kernels) and no weighted kernel. The train step's launches
    every kernel inside a nested span (the mask draws in
    `model.APPNP.edge_drop`, the hops in `kernel.spmm_csr_weighted`), so
    it has none (test_device_annotation_follows_only_direct_launches)."""
    from glnn_tpu_torch.utils.trace_report import port_name

    recs, events, *_ = _traced_appnp_epoch(cuda, tmp_path)

    def annotations(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "gpu_user_annotation"
                and e.get("name") == name]

    def kernels(port):
        return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("cat") == "kernel" and e.get("ph") == "X"
                and port_name(e.get("name", "")) == port]

    slack = 1.0                                   # us: the trace's rounding

    def inside(ks, lo, hi):
        return [k for k in ks if lo - slack <= k[0] and k[1] <= hi + slack]

    assert sum(r.name == "model.APPNP.propagate" for r in recs) == 2
    weighted, int8 = kernels("spmm_csr_weighted"), kernels("spmm_csr_int8")
    assert len(weighted) == 40 and len(int8) == 20
    prop = annotations("model.APPNP.propagate")
    assert len(prop) == 1
    assert len(inside(weighted, *prop[0])) == 0
    assert len(inside(int8, *prop[0])) == 18
    assert max(k[1] for k in weighted) <= prop[0][0] + slack
    passes = collections.Counter(k[2].split("Appnp<")[1][0]
                                 for k in weighted + int8)
    assert passes == {"0": 20, "1": 20, "2": 20}
    forward = [k for k in weighted if "Appnp<0>" in k[2]]
    transposed = [k for k in weighted if "Appnp<1>" in k[2]]
    assert max(k[1] for k in forward) <= min(k[0] for k in transposed)
    for name, ks, calls in (("kernel.spmm_csr_weighted", weighted, 20),
                            ("kernel.spmm_csr_int8", int8, 10)):
        wrapped = annotations(name)
        assert len(wrapped) == calls
        for lo, hi in wrapped:
            pair = inside(ks, lo, hi)
            assert len(pair) == 2
            assert pair[0][2].split("Appnp<")[1][0] == \
                pair[1][2].split("Appnp<")[1][0]


# ---- APPNP's hop fused into the walks ----------------------------------------
# Each fused hop rounds every step as the composed kernels and torch ops do,
# and its walk sums in the composed walk's order, so it is bit-equal to them
# per hop, forward and backward; over the whole K = 10 propagate autograd
# adds h0's terms in the composition's order, so the gradient is too.

APPNP_ALPHA = 0.1


@functools.lru_cache(maxsize=1)
def _arxiv_graph(device):
    """ogbn-arxiv's shape with Redner-law rows (past HUB_CHUNK in both
    walks), as the APPNP epoch tests take it."""
    return _power_law_graph(169343, 1166243, 21, device)


def _hop_inputs(g, f, seed):
    gen = torch.Generator(device=g.device).manual_seed(seed)
    h, h0, co = (torch.randn(g.n_nodes, f, generator=gen, device=g.device)
                 for _ in range(3))
    w = (torch.rand(g.n_edges, generator=gen, device=g.device)
         >= 0.5).float() / 0.5
    return h, h0, co, w


@pytest.mark.parametrize("f", [40, 7, 128])
def test_fused_hops_equal_the_composed_kernels(cuda, f):
    """At ogbn-arxiv's shape: the fused weighted hop's forward, dX and dh0
    and the fused int8 eval hop equal gcn_norm_both's kernels and the
    teleport's torch ops bit for bit (F = 40 the cell's width, F = 7 the
    scalar epilogue, F = 128 a one-group layout). The edge-drop weights
    zero about half the edges, so the fused walks and the composition's
    weighted sums both gather the compacted windows, in one order."""
    g = _arxiv_graph(cuda)
    n = g.n_nodes
    assert spmm_cuda.plan_of(g, "indptr", n).n_chunks > 0
    assert spmm_cuda.plan_of(g, "t_indptr", n).n_chunks > 0
    h, h0, co, w = _hop_inputs(g, f, f)

    def run(hop):
        a, b = h.clone().requires_grad_(True), h0.clone().requires_grad_(True)
        out = hop(a, b)
        (out * co).sum().backward()
        return out.detach(), a.grad, b.grad

    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    fused = run(lambda a, b: spmm_cuda.appnp_hop(g, a, b, w, APPNP_ALPHA))
    assert spmm_cuda.counts["spmm_csr_weighted"] == 4
    composed = run(lambda a, b: (1.0 - APPNP_ALPHA)
                   * ops.gcn_norm_both(g, a, w) + APPNP_ALPHA * b)
    for got, want in zip(fused, composed):
        assert torch.equal(got, want)
    with torch.no_grad():
        fused = spmm_cuda.appnp_hop_int8(g, h, h0, APPNP_ALPHA)
        with ops.inference_mode():
            composed = ((1.0 - APPNP_ALPHA) * ops.gcn_norm_both(g, h)
                        + APPNP_ALPHA * h0)
    assert torch.equal(fused, composed)
    assert spmm_cuda.counts["spmm_csr_int8"] == 4
    assert cuda_build.counts == {"plain_on_cuda": 0}


def test_fused_hop_on_a_misaligned_h0(cuda):
    """An h0 whose base is not 16-byte aligned is copied before the walk
    reads it as float4 rows; the hop keeps its numbers."""
    g = _arxiv_graph(cuda)
    h, h0, _, w = _hop_inputs(g, 40, 3)
    wide = torch.zeros(g.n_nodes * 40 + 1, device=cuda)
    off = wide[1:].view(g.n_nodes, 40)
    off.copy_(h0)
    assert off.data_ptr() % 16 != 0
    with torch.no_grad():
        assert torch.equal(spmm_cuda.appnp_hop(g, h, off, w, APPNP_ALPHA),
                           spmm_cuda.appnp_hop(g, h, h0, w, APPNP_ALPHA))
        assert torch.equal(spmm_cuda.appnp_hop_int8(g, h, off, APPNP_ALPHA),
                           spmm_cuda.appnp_hop_int8(g, h, h0, APPNP_ALPHA))


@pytest.mark.parametrize("training", [True, False])
def test_fused_propagate_matches_the_composed_one(cuda, monkeypatch,
                                                  training):
    """The whole K = 10 propagate at ogbn-arxiv's shape on the fused hops
    against every hop composed: the logits and the gradient bit for bit;
    every hop on its path."""
    from glnn_tpu_torch.nn import appnp_propagate

    g = _arxiv_graph(cuda)
    h, _, co, _ = _hop_inputs(g, 40, 11)
    gen = torch.Generator(device=cuda).manual_seed(5)
    masks = [torch.rand(g.n_edges, generator=gen, device=cuda) >= 0.5
             for _ in range(10)]

    def run():
        ops.reset_counts()
        x = h.clone().requires_grad_(training)
        if not training:
            with torch.no_grad(), ops.inference_mode():
                return appnp_propagate(g, x, 10, APPNP_ALPHA, 0.5), None, \
                    dict(ops.hop_counts)
        out = appnp_propagate(g, x, 10, APPNP_ALPHA, 0.5, training=True,
                              masks=masks)
        grad, = torch.autograd.grad((out * co).sum(), x)
        return out.detach(), grad, dict(ops.hop_counts)

    out, grad, hops = run()
    assert hops["fused_weighted" if training else "fused_int8"] == 10
    monkeypatch.setattr(ops, "_appnp_path", lambda *a: "composed")
    out_c, grad_c, hops_c = run()
    assert hops_c["composed"] == 10
    assert torch.equal(out, out_c)
    if training:
        assert torch.equal(grad, grad_c)


# ---- the MLP eval's CUDA graphs ---------------------------------------------
# `make_mlp_eval_fn` on the card replays one captured graph per row bucket.
# Its output is held to the eager forward (today's path: the same ops at
# the chunk's own row count) within EVAL_ULPS ulps of the compute dtype at
# the largest |log-prob|: the matrix products may take another cuBLAS
# kernel at the bucket's row count, which sums in another order; f32 gives
# a few f32 ulps, bf16 rounds each layer's product to bf16, so a last-bit
# difference can flip one bf16 rounding.

EVAL_ULPS = {"float32": (8, 2.0 ** -23), "bfloat16": (2, 2.0 ** -7)}
# the serve traffic's request sizes: 256 log-uniform over 10-4,096 rows
SERVE_SIZES = np.unique(np.rint(np.exp(np.log(10) + np.arange(256) / 255
                                       * (np.log(4096) - np.log(10))))
                        .astype(int)).tolist()


@pytest.fixture()
def f32_matmul():
    """Full f32 matrix products (the configuration's), restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _student(device, dtype="float32", seed=0):
    """GLNN's products student (3 x 256, batch norm), its affine terms and
    running statistics drawn as a trained model holds them."""
    from glnn_tpu_torch.nn.models import Model

    conf = dict(model_name="MLP", num_layers=3, hidden_dim=256, feat_dim=100,
                label_dim=47, dropout_ratio=0.5, norm_type="batch",
                compute_dtype=dtype)
    model = Model(conf, torch.Generator().manual_seed(seed)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for bn in model.module.norms:
            bn.running_mean.normal_(0.0, 0.5, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
    return model


def _eager(model, x):
    from glnn_tpu_torch.train.losses import log_softmax

    model.eval()
    with torch.no_grad():
        return log_softmax(model(None, x)[1])


def _ulp_gap(got, want, dtype="float32"):
    """(max |got - want| in ulps of `dtype` at max |want|, its bound)."""
    n, eps = EVAL_ULPS[dtype]
    top = want.abs().max().item()
    ulp = eps * 2.0 ** np.floor(np.log2(max(top, 2.0 ** -126)))
    return (got - want).abs().max().item() / ulp, n


def _graphs():
    from glnn_tpu_torch.train import engine

    return engine.eval_graph_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_eval_graph_equals_eager_at_every_serve_size(cuda, f32_matmul,
                                                         dtype):
    """One call at each size the serve traffic draws, smallest first: 33
    buckets captured, one replay a call, each output within a few ulps of
    the eager forward and bit-equal run to run."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda, dtype)
    evaluate = engine.make_mlp_eval_fn(model)
    gen = torch.Generator(device=cuda).manual_seed(1)
    before, worst = _graphs(), 0.0
    for size in SERVE_SIZES:
        x = torch.randn(size, 100, device=cuda, generator=gen)
        got = evaluate(x)
        assert got.shape == (size, 47) and got.dtype == torch.float32
        gap, bound = _ulp_gap(got, _eager(model, x), dtype)
        assert gap <= bound, (size, gap)
        worst = max(worst, gap)
        assert torch.equal(evaluate(x), got)
    after = _graphs()
    assert after["captures"] - before["captures"] == 33
    assert after["replays"] - before["replays"] == 2 * len(SERVE_SIZES)
    assert after["eager"] == before["eager"]
    assert sorted(evaluate.graphs.graphs) == sorted(
        {engine.row_bucket(s) for s in SERVE_SIZES})
    print(f"mlp eval graph {dtype}: widest gap {worst:.2f} ulps over "
          f"{len(SERVE_SIZES)} sizes")


def test_mlp_eval_graph_second_pass_captures_nothing(cuda, f32_matmul):
    """After one pass over the traffic's sizes a second pass, in another
    order, replays only: zero captures."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    for size in SERVE_SIZES:
        evaluate(torch.randn(size, 100, device=cuda))
    before = _graphs()
    for size in np.random.RandomState(0).permutation(SERVE_SIZES):
        evaluate(torch.randn(int(size), 100, device=cuda))
    after = _graphs()
    assert after["captures"] == before["captures"]
    assert after["replays"] - before["replays"] == len(SERVE_SIZES)


def test_mlp_eval_graph_buckets_replayed_out_of_capture_order(cuda,
                                                              f32_matmul):
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    xs = {n: torch.randn(n, 100, device=cuda) for n in (10, 17, 300, 4096)}
    for n in sorted(xs):                          # captured smallest first
        evaluate(xs[n])
    before = _graphs()
    for n in (4096, 10, 300, 17, 4096, 300, 10):
        gap, bound = _ulp_gap(evaluate(xs[n]), _eager(model, xs[n]))
        assert gap <= bound, (n, gap)
    assert _graphs()["captures"] == before["captures"]


def test_mlp_eval_graph_padding_rows_never_reach_real_rows(cuda, f32_matmul):
    """NaN planted in a static input's padding rows leaves the real rows
    as they were."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x = torch.randn(300, 100, device=cuda)
    clean = evaluate(x)
    bucket = engine.row_bucket(300)
    assert bucket > 300
    _, static_in, _ = evaluate.graphs.graphs[bucket]
    static_in[300:] = float("nan")
    got = evaluate(x)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    assert torch.isnan(static_in[300:]).all()


def test_mlp_eval_graph_outputs_are_not_aliased(cuda, f32_matmul):
    """Two calls in one bucket give two tensors of their own: the first
    keeps its values after the second, and neither is the static output."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x1, x2 = torch.randn(200, 100, device=cuda), torch.randn(190, 100,
                                                             device=cuda)
    a = evaluate(x1)
    kept = a.clone()
    b = evaluate(x2)
    assert torch.equal(a, kept)
    _, _, static_out = evaluate.graphs.graphs[engine.row_bucket(200)]
    ptrs = {t.untyped_storage().data_ptr() for t in (a, b, static_out)}
    assert len(ptrs) == 3
    gap, bound = _ulp_gap(b, _eager(model, x2))
    assert gap <= bound


def test_mlp_eval_graph_sees_in_place_updates(cuda, f32_matmul):
    """Parameters and running statistics changed in place (an optimizer
    step, a training forward, `load_state_dict`) keep their addresses:
    the replay reads them, with no capture."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x = torch.randn(500, 100, device=cuda)
    first = evaluate(x)
    before = _graphs()
    with torch.no_grad():
        model.module.layers[1].weight.mul_(1.5)
        model.module.norms[0].running_mean.add_(0.25)
        model.module.norms[1].running_var.mul_(2.0)
    got = evaluate(x)
    assert not torch.allclose(got, first)
    gap, bound = _ulp_gap(got, _eager(model, x))
    assert gap <= bound
    model.load_state_dict(_student(cuda, seed=5).state_dict())
    got = evaluate(x)
    gap, bound = _ulp_gap(got, _eager(model, x))
    assert gap <= bound
    assert _graphs()["captures"] == before["captures"]


def test_mlp_eval_graph_recaptures_on_new_parameters_and_tf32(cuda,
                                                              f32_matmul):
    """A replaced parameter (a new address) and a flipped TF32 flag each
    drop the graphs and capture anew."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x = torch.randn(700, 100, device=cuda)
    evaluate(x)
    c0 = _graphs()["captures"]
    layer = model.module.layers[0]
    layer.weight = torch.nn.Parameter(layer.weight.detach() * -1.0)
    gap, bound = _ulp_gap(evaluate(x), _eager(model, x))
    assert gap <= bound
    assert _graphs()["captures"] == c0 + 1
    torch.backends.cuda.matmul.allow_tf32 = True
    got = evaluate(x)
    assert _graphs()["captures"] == c0 + 2
    # TF32 keeps 10 of f32's 23 mantissa bits
    gap, _ = _ulp_gap(got, _eager(model, x))
    assert gap * 2.0 ** -13 <= 8
    torch.backends.cuda.matmul.allow_tf32 = False
    evaluate(x)
    assert _graphs()["captures"] == c0 + 3
    assert len(evaluate.graphs.graphs) == 1


@pytest.mark.parametrize("rows,batch", [(37, 8), (4096 * 3 + 5, 4096),
                                        (65536 + 100, None)])
def test_mlp_eval_graph_chunks_equal_eager(cuda, f32_matmul, rows, batch):
    """Chunks of `batch` rows, and pieces of GRAPH_ROWS where the input is
    larger: one replay a chunk, the rows in order."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model, batch)
    x = torch.randn(rows, 100, device=cuda)
    before = _graphs()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    got = evaluate(x)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    step = min(batch or rows, engine.GRAPH_ROWS)
    assert _graphs()["replays"] - before["replays"] == -(-rows // step)
    gap, bound = _ulp_gap(got, _eager(model, x))
    assert gap <= bound
    print(f"mlp eval graph rows {rows} batch {batch}: {gap:.2f} ulps, "
          f"peak {peak / 2**20:.1f} MiB above the inputs")


def test_mlp_eval_graph_replay_in_the_trace(cuda, f32_matmul, tmp_path):
    """Under the profiler a replayed eval records `runner.eval_graph`
    inside `runner.eval`, and the graph's kernels appear in the trace
    inside the span's device annotation."""
    from glnn_tpu_torch.train import engine
    from glnn_tpu_torch.utils import profiling

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x = torch.randn(1000, 100, device=cuda)
    evaluate(x)
    profiling.clear_spans()
    with profiling.trace(tmp_path, cuda) as t:
        evaluate(x)
    totals = profiling.span_totals()
    recs = profiling.span_records()
    profiling.clear_spans()
    assert totals["runner.eval"][0] == 1 and totals["runner.eval_graph"][0] == 1
    outer, = [r for r in recs if r.name == "runner.eval"]
    inner, = [r for r in recs if r.name == "runner.eval_graph"]
    assert inner.parent == outer.id
    assert not any(r.name.startswith("model.") for r in recs)
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    ann = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "gpu_user_annotation"
           and e.get("name") == "runner.eval_graph"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    assert len(ann) == 1
    lo, hi = ann[0]
    inside = [k for k in kernels if lo - 1.0 <= k[0] and k[1] <= hi + 1.0]
    # three products, the batch norms' and relus' elementwise ops, the
    # log-softmax
    assert len(inside) >= 5
    print(f"mlp eval graph trace: {len(inside)} kernels in the replay's "
          f"annotation, {len(kernels)} in all")


def test_mlp_eval_graph_puts_the_model_in_eval_mode(cuda, f32_matmul):
    """A model left in training mode is put in eval mode before its
    replay, as the eager path does: the output is the eval forward's."""
    from glnn_tpu_torch.train import engine

    model = _student(cuda)
    evaluate = engine.make_mlp_eval_fn(model)
    x = torch.randn(64, 100, device=cuda)
    first = evaluate(x)
    model.train()
    model.module.norms[1].train()
    got = evaluate(x)
    assert not any(m.training for m in model.modules())
    assert torch.equal(got, first)
