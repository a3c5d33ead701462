"""The port's GCN and APPNP paths against glnn_tpu: gcn_norm_both against
refops, the weighted SpMM's plain version against the interpret-mode Pallas
u_mul_e_sum (spmm_pallas.py:438), GraphConv, GCN and APPNP eval forwards
after from_jax_variables, APPNP propagation in training on JAX's own
edge-drop masks, one full-batch step, and the CLIs.

Tolerances: the f32 plain tier at rtol 1e-5 (refops); the weighted sum at
rtol 1e-5 / atol 1e-5, tighter than test_pallas.py:96's 2e-2 / 5e-2,
because both round each message x[src] * w to bf16 once, from the same f32
product, and differ only in summation order; the model forwards and the
train step at rtol 1e-5 (f32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu import ops as jax_ops
from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.nn.layers import GraphConv as JaxGraphConv
from glnn_tpu.nn.layers import appnp_propagate as jax_appnp_propagate
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu.ops import refops as jax_refops
from glnn_tpu.ops import spmm_pallas
from glnn_tpu.train.engine import make_gnn_train_step as jax_gnn_step
from glnn_tpu.train.state import create_train_state
from glnn_tpu.train.state import make_adam as jax_make_adam
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn import (GraphConv, Model, appnp_propagate,
                               from_jax_variables)
from glnn_tpu_torch.ops import cuda_build, refops, spmm_cuda
from glnn_tpu_torch.train import make_adam, make_gnn_train_step

N, F_IN, CLASSES = 300, 12, 5


def _graphs(n=N, e=2500, seed=4, hub_free=0, plans=False):
    """The same dst-sorted graph in both packages; its first `hub_free`
    nodes receive no edges."""
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(hub_free, n, e)
    gj = jax_build_graph(src, dst, n)
    return build_graph(src, dst, n), gj.with_plans() if plans else gj


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(autouse=True)
def _default_backends():
    ops.set_backend("auto")
    jax_ops.set_backend("auto")
    yield
    ops.set_backend("auto")
    jax_ops.set_backend("auto")


# ---- gcn_norm_both against glnn_tpu.ops.refops ----------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_norm_both_matches_refops(weighted):
    """Nodes 0..19 receive no edges (in-degree clamped to 1)."""
    gt, gj = _graphs(hub_free=20)
    rs = np.random.RandomState(1)
    x = rs.randn(N, 16).astype(np.float32)
    w = (rs.rand(gt.n_edges) * 2).astype(np.float32) if weighted else None
    want = np.asarray(jax_refops.gcn_norm_both(
        gj, jnp.asarray(x), None if w is None else jnp.asarray(w)))
    wt = None if w is None else torch.from_numpy(w)
    # the plain body, and the dispatcher under "auto" and "xla" (both reach
    # the plain f32 sums on the CPU)
    for backend, fn in (("auto", refops.gcn_norm_both),
                        ("auto", ops.gcn_norm_both),
                        ("xla", ops.gcn_norm_both)):
        ops.set_backend(backend)
        got = fn(gt, torch.from_numpy(x), wt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.abs(got[:20]).max() == 0.0


# ---- the weighted kernel's plain version against the Pallas kernel --------

def _weighted_inputs(heads, kind, seed=5):
    gt, gj = _graphs(n=200, e=1500, seed=seed, hub_free=10, plans=True)
    rs = np.random.RandomState(seed)
    xshape = (200, 24) if heads is None else (200, heads, 6)
    wshape = (gt.n_edges,) if heads is None else (gt.n_edges, heads)
    x = rs.randn(*xshape).astype(np.float32)
    if kind == "keep":            # APPNP's edge-drop weights {0, 2}
        w = (rs.rand(*wshape) >= 0.5).astype(np.float32) * 2.0
    else:
        w = rs.rand(*wshape).astype(np.float32)
    co = rs.randn(*xshape).astype(np.float32)
    return gt, gj, x, w, co


@pytest.mark.parametrize("heads,kind", [(None, "keep"), (None, "uniform"),
                                        (4, "uniform")])
def test_weighted_plain_matches_pallas_interpret(heads, kind):
    """Forward, dX and dW of the port's autograd.Function on the CPU (the
    plain version) against spmm_pallas.u_mul_e_sum in interpret mode."""
    gt, gj, x, w, co = _weighted_inputs(heads, kind)

    def loss(fn):
        return lambda xx, ww: (fn(xx, ww) * jnp.asarray(co)).sum()

    pallas = lambda xx, ww: spmm_pallas.u_mul_e_sum(gj, xx, ww)  # noqa: E731
    want = np.asarray(pallas(*_j(x, w)))
    dx_want, dw_want = jax.grad(loss(pallas), argnums=(0, 1))(*_j(x, w))

    xt, wt = [t.requires_grad_(True) for t in _t(x, w)]
    got = spmm_cuda.u_mul_e_sum(gt, xt, wt)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_want),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(got.detach().numpy()[:10]).max() == 0.0
    # and the f32 oracle at the Pallas tests' bf16 tolerance
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jax_refops.u_mul_e_sum(gj, *_j(x, w))), rtol=2e-2,
        atol=5e-2)


def test_weighted_rounds_the_product_once():
    """Each message is bf16(x * w) with the product in f32 (JAX's order,
    spmm_pallas.py:298-309), not bf16(x) * w."""
    g = build_graph(np.array([0]), np.array([1]), 2)
    x = torch.tensor([[1.0 + 3 * 2.0 ** -9], [0.0]])   # not a bf16 value
    w = torch.tensor([3.0])
    got = spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, x, w, 2)
    want = (x[0, 0] * 3.0).to(torch.bfloat16).float()
    assert got[1, 0] == want == 3.0 + 2.0 ** -6 and got[0, 0] == 0.0
    assert x[0, 0].to(torch.bfloat16).float() * 3.0 == 3.0 + 3 * 2.0 ** -7


def test_weighted_transposed_walk_reads_weights_through_t_edges():
    """The backward's walk over (t_indptr, t_receivers) with widx = t_edges
    equals the plain transpose: sum over out-edges of bf16(dh[dst] w)."""
    gt, _, _, w, _ = _weighted_inputs(None, "uniform", seed=6)
    dh = torch.randn(200, 9, generator=torch.Generator().manual_seed(0))
    got = spmm_cuda.csr_wsum_bf16(gt.t_indptr, gt.t_receivers, gt.t_edges,
                                  dh, torch.from_numpy(w), 200)
    msgs = (dh[gt.receivers.long()] * torch.from_numpy(w)[:, None]).to(
        torch.bfloat16).float()
    want = torch.zeros(200, 9).index_add_(0, gt.senders.long(), msgs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_weighted_wrappers_reject_bad_inputs():
    gt, _ = _graphs(e=400)
    x, w = torch.zeros(N, 6), torch.zeros(gt.n_edges)
    with pytest.raises(TypeError):              # bf16 rows: the kernel reads f32
        spmm_cuda.csr_wsum_bf16(gt.indptr, gt.senders, None,
                                x.to(torch.bfloat16), w, N)
    with pytest.raises(TypeError):              # 4 heads do not divide F = 6
        spmm_cuda.csr_wsum_bf16(gt.indptr, gt.senders, None, x,
                                torch.zeros(gt.n_edges, 4), N)
    with pytest.raises(TypeError):
        spmm_cuda.csr_wsum_bf16(gt.indptr, gt.senders, gt.t_edges.long(), x,
                                w, N)
    with pytest.raises(ValueError):             # per-head weights need [N, H, D]
        spmm_cuda.u_mul_e_sum(gt, x, torch.zeros(gt.n_edges, 2))
    with pytest.raises(ValueError):
        spmm_cuda.u_mul_e_sum(gt, torch.zeros(N, 3, 2),
                              torch.zeros(gt.n_edges, 2))


def test_dispatcher_weighted_tiers_on_cpu():
    """auto and xla: the f32 plain tier; pallas and pallas_int8: the bf16
    weighted plain version (the int8 tier covers only the unweighted sum);
    gcn_norm_both routes through both dispatched sums. No launch and no
    plain call counts on the CPU."""
    gt, gj = _graphs(seed=8, hub_free=5)
    rs = np.random.RandomState(9)
    x = rs.randn(N, 10).astype(np.float32)
    w = (rs.rand(gt.n_edges) >= 0.5).astype(np.float32) * 2.0
    xt, wt = _t(x, w)
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()
    f32 = np.asarray(jax_refops.u_mul_e_sum(gj, *_j(x, w)))
    for backend in ("auto", "xla"):
        ops.set_backend(backend)
        np.testing.assert_allclose(ops.u_mul_e_sum(gt, xt, wt).numpy(), f32,
                                   rtol=1e-5, atol=1e-5)
    kernel = spmm_cuda.u_mul_e_sum(gt, xt, wt)
    for backend in ("pallas", "pallas_int8"):
        ops.set_backend(backend)
        with ops.inference_mode():
            assert torch.equal(ops.u_mul_e_sum(gt, xt, wt), kernel)
        norm_w = ops.gcn_norm_both(gt, xt, wt)
        src = torch.rsqrt(gt.out_degrees.clamp(min=1.0))[:, None]
        dst = torch.rsqrt(gt.in_degrees.clamp(min=1.0))[:, None]
        assert torch.equal(norm_w, spmm_cuda.u_mul_e_sum(gt, xt * src, wt)
                           * dst)
    ops.set_backend("pallas_int8")
    assert torch.equal(ops.gcn_norm_both(gt, xt),
                       spmm_cuda.copy_u_sum_int8(
                           gt, xt * torch.rsqrt(gt.out_degrees.clamp(min=1.0))
                           [:, None])
                       * torch.rsqrt(gt.in_degrees.clamp(min=1.0))[:, None])
    assert spmm_cuda.counts == {k: 0 for k in spmm_cuda.KERNELS}
    assert cuda_build.counts == {"plain_on_cuda": 0}


# ---- layers and models against glnn_tpu -----------------------------------

@pytest.mark.parametrize("in_dim,out_dim", [(12, 5), (5, 12)])
def test_graphconv_matches_jax(in_dim, out_dim):
    """Both orders of GraphConv (W before the aggregation when in > out)."""
    gt, gj = _graphs(hub_free=7)
    rs = np.random.RandomState(2)
    x = rs.randn(N, in_dim).astype(np.float32)
    layer = JaxGraphConv(out_dim, activation=jax.nn.relu)
    v = jax.tree_util.tree_map(np.asarray, layer.init(
        jax.random.PRNGKey(0), gj, jnp.asarray(x)))
    v["params"]["bias"] = rs.randn(out_dim).astype(np.float32)
    want = np.asarray(layer.apply(v, gj, jnp.asarray(x)))
    conv = GraphConv(in_dim, out_dim, activation=torch.relu)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(v["params"]["kernel"])))
        conv.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = conv(gt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_graphconv_init():
    gen = torch.Generator().manual_seed(0)
    conv = GraphConv(200, 300, gen=gen)
    bound = np.sqrt(6.0 / (200 + 300))
    assert conv.weight.shape == (200, 300)
    assert conv.weight.abs().max().item() <= bound
    assert abs(conv.weight.std().item() - bound / np.sqrt(3)) < 0.02 * bound
    assert conv.bias.abs().max().item() == 0.0
    again = GraphConv(200, 300, gen=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, conv.weight)


def _conf(name, layers=2, norm="none", dropout=0.0):
    return dict(model_name=name, num_layers=layers, hidden_dim=16,
                feat_dim=F_IN, label_dim=CLASSES, dropout_ratio=dropout,
                norm_type=norm)


def _setup(conf, edge_drop=None):
    """JAX-initialised weights (with non-trivial running statistics)
    carried into the port."""
    gt, gj = _graphs(hub_free=10)
    rs = np.random.RandomState(0)
    x = rs.randn(N, F_IN).astype(np.float32)
    jm = JaxModel(conf)
    if edge_drop is not None:
        jm.module = jm.module.clone(edge_drop=edge_drop)
    v = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x)))
    for st in v.get("batch_stats", {}).values():
        st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32) * 0.3
        st["var"] = rs.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    tm = Model(conf)
    if edge_drop is not None:
        tm.module.edge_drop = edge_drop
    from_jax_variables(v, tm)
    return jm, v, gj, tm, gt, x


@pytest.mark.parametrize("name,layers,norm", [
    ("GCN", 1, "none"), ("GCN", 2, "none"), ("GCN", 3, "batch"),
    ("APPNP", 2, "none"), ("APPNP", 3, "layer")])
def test_eval_forward_matches_jax(name, layers, norm):
    """Eval mode (no dropout, no edge drop), f32 tiers on both sides; a
    1-layer GCN keeps the relu on its single layer."""
    jm, v, gj, tm, gt, x = _setup(_conf(name, layers, norm, dropout=0.5))
    want_list, want = jm.apply(v, gj, jnp.asarray(x), training=False)
    tm.eval()
    with torch.no_grad():
        h_list, got = tm(gt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert len(h_list) == len(want_list) == layers - 1
    for a, b in zip(h_list, want_list):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    if name == "GCN" and layers == 1:
        assert got.min().item() >= 0.0


def test_appnp_propagate_matches_jax_with_its_masks():
    """Training-mode propagation with edge drop 0.5, fed JAX's own per-hop
    masks bernoulli(fold_in(rng, i), 1 - p, (E,))."""
    gt, gj = _graphs(hub_free=10)
    h = np.random.RandomState(3).randn(N, 7).astype(np.float32)
    rng, k, p = jax.random.PRNGKey(5), 4, 0.5
    want = np.asarray(jax_appnp_propagate(gj, jnp.asarray(h), k, 0.1, p,
                                          training=True, rng=rng))
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(rng, i), 1.0 - p, (gj.e_pad,)))) for i in range(k)]
    got = appnp_propagate(gt, torch.from_numpy(h), k, 0.1, p, training=True,
                          masks=masks).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the masks matter: without edge drop the result differs
    assert not np.allclose(got, np.asarray(jax_appnp_propagate(
        gj, jnp.asarray(h), k, 0.1, p, training=False)), atol=1e-3)


def test_appnp_edge_drop_draws_from_generator():
    gt, _ = _graphs()
    h = torch.randn(N, 5, generator=torch.Generator().manual_seed(0))
    outs = [appnp_propagate(gt, h, 3, 0.1, 0.5, training=True,
                            gen=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    gen = torch.Generator().manual_seed(0)
    masks = [torch.rand((gt.n_edges,), generator=gen) >= 0.5
             for _ in range(3)]
    torch.testing.assert_close(
        outs[0], appnp_propagate(gt, h, 3, 0.1, 0.5, training=True,
                                 masks=masks))


@pytest.mark.parametrize("name", ["GCN", "APPNP"])
def test_gnn_train_step_matches_jax(name):
    """Dropout and edge drop at 0 on both sides: one full-batch NLL + Adam
    step gives the JAX loss and updated parameters."""
    jm, v, gj, tm, gt, x = _setup(_conf(name), edge_drop=0.0
                                  if name == "APPNP" else None)
    labels = np.random.RandomState(1).randint(0, CLASSES, N)
    idx_train = np.arange(0, N, 3)
    opt = jax_make_adam(0.01, 0.001)
    state, loss_j = jax_gnn_step(jm, opt)(
        create_train_state(v, opt), gj, jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(idx_train), jax.random.PRNGKey(0))
    step = make_gnn_train_step(tm, make_adam(tm.parameters(), 0.01, 0.001))
    loss_t = step(gt, *_t(x, labels, idx_train), None)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = Model(_conf(name))
    want = jax.tree_util.tree_map(np.asarray, dict(v, params=state.params))
    from_jax_variables(want, got)
    for a, b in zip(tm.parameters(), got.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---- APPNP's fused hop against the composition it replaces ----------------
# Under a kernel tier on the CPU both paths run the kernels' plain versions,
# which round each step as the kernels do, so a hop is bit-equal to
# gcn_norm_both followed by the teleport; the fused hop hands autograd h0's
# gradient before h's, as the teleport does, so the whole propagate's
# gradient adds h0's eleven terms in the composition's order, bit for bit.

ALPHA = 0.1


def _skewed(seed=11, n=1500):
    """A directed graph with rows past HUB_CHUNK in both walks (node 0's
    1,300 in-edges, node 1's 900 out-edges), in- and out-degrees that
    differ, and nodes 2..9 with no in-edges; and its RandomState."""
    rs = np.random.RandomState(seed)
    src = np.concatenate([rs.randint(0, n, 6000), rs.randint(0, n, 1300),
                          np.ones(900, np.int64)])
    dst = np.concatenate([rs.randint(10, n, 6000), np.zeros(1300, np.int64),
                          rs.randint(10, n, 900)])
    g = build_graph(src, dst, n)
    assert spmm_cuda.plan_of(g, "indptr", n).n_chunks > 0
    assert spmm_cuda.plan_of(g, "t_indptr", n).n_chunks > 0
    return g, rs


def _rows(rs, g, f=40, k=1):
    return [torch.from_numpy(rs.randn(g.n_nodes, f).astype(np.float32))
            for _ in range(k)]


@pytest.fixture()
def kernel_tier(monkeypatch):
    monkeypatch.setattr(ops, "_tier_selected", lambda device: True)


def test_degree_norms_are_kept_and_equal_the_recomputed():
    g, _ = _skewed()
    src_norm, dst_norm = refops.degree_norms(g)
    assert torch.equal(src_norm, torch.rsqrt(g.out_degrees.clamp(min=1.0)))
    assert torch.equal(dst_norm, torch.rsqrt(g.in_degrees.clamp(min=1.0)))
    assert not torch.equal(src_norm, dst_norm)
    again = refops.degree_norms(g)
    assert again[0] is src_norm and again[1] is dst_norm
    assert g.to("cpu").cache == {}                 # a moved graph's own
    x = _rows(np.random.RandomState(3), g)[0]
    assert torch.equal(
        refops.gcn_norm_both(g, x),
        refops.copy_u_sum(g, x * torch.rsqrt(g.out_degrees.clamp(min=1.0))
                          [:, None])
        * torch.rsqrt(g.in_degrees.clamp(min=1.0))[:, None])


@pytest.mark.parametrize("alpha", [ALPHA, 0.3])
def test_fused_weighted_hop_equals_the_composition(kernel_tier, alpha):
    """Forward, dX and dh0 of `spmm_cuda.appnp_hop` against gcn_norm_both
    with the edge-drop weights, then the teleport, bit for bit."""
    g, rs = _skewed()
    h, h0, co = _rows(rs, g, k=3)
    w = torch.from_numpy((rs.rand(g.n_edges) >= 0.5).astype(np.float32) * 2)

    def run(hop):
        a, b = h.clone().requires_grad_(True), h0.clone().requires_grad_(True)
        out = hop(a, b)
        (out * co).sum().backward()
        return out.detach(), a.grad, b.grad

    fused = run(lambda a, b: spmm_cuda.appnp_hop(g, a, b, w, alpha))
    composed = run(lambda a, b: (1.0 - alpha) * ops.gcn_norm_both(g, a, w)
                   + alpha * b)
    for got, want in zip(fused, composed):
        assert torch.equal(got, want)
    assert not torch.equal(fused[1], composed[2])


def test_fused_int8_hop_equals_the_composition(kernel_tier):
    g, rs = _skewed()
    h, h0 = _rows(rs, g, k=2)
    with torch.no_grad():
        with ops.inference_mode():
            composed = (1.0 - ALPHA) * ops.gcn_norm_both(g, h) + ALPHA * h0
        fused = spmm_cuda.appnp_hop_int8(g, h, h0, ALPHA)
        exact = (1.0 - ALPHA) * ops.gcn_norm_both(g, h) + ALPHA * h0
    assert torch.equal(fused, composed)
    assert not torch.equal(fused, exact)         # the int8 tier was taken


def _propagate(g, h, masks, training):
    """appnp_propagate's output, the gradient of <output, 1 + h> in h
    (training), and its hops by path."""
    ops.reset_counts()
    h = h.clone().requires_grad_(training)
    if training:
        out = appnp_propagate(g, h, 10, ALPHA, 0.5, training=True,
                              masks=masks)
        grad, = torch.autograd.grad((out * (1.0 + h.detach())).sum(), h)
    else:
        with torch.no_grad(), ops.inference_mode():
            out = appnp_propagate(g, h, 10, ALPHA, 0.5)
        grad = None
    return out.detach(), grad, dict(ops.hop_counts)


@pytest.mark.parametrize("training", [True, False])
def test_appnp_propagate_gives_the_same_logits_on_both_paths(
        kernel_tier, monkeypatch, training):
    g, rs = _skewed()
    h, = _rows(rs, g)
    masks = [torch.from_numpy(rs.rand(g.n_edges) >= 0.5) for _ in range(10)]
    out, grad, hops = _propagate(g, h, masks, training)
    path = "fused_weighted" if training else "fused_int8"
    assert hops == dict({"fused_weighted": 0, "fused_int8": 0,
                         "composed": 0}, **{path: 10})
    monkeypatch.setattr(ops, "_appnp_path", lambda *a: "composed")
    out_c, grad_c, hops_c = _propagate(g, h, masks, training)
    assert hops_c["composed"] == 10
    assert torch.equal(out, out_c)
    if training:
        assert torch.equal(grad, grad_c)


def _halo_shard():
    from glnn_tpu_torch.distributed.halo import build_halo_graph

    rs = np.random.RandomState(5)
    shard, = build_halo_graph(rs.randint(0, 60, 400), rs.randint(0, 60, 400),
                              60, 1, combined=True)
    return shard


# case -> (setup on the monkeypatch, graph, h's dtype, training, edge drop,
# eval under inference_mode, the path every hop takes; bf16 h: the first
# hop's f32 norms promote the rows to f32, and h0 stays bf16)
HOP_PATHS = {
    "weighted": ("kernel", "graph", torch.float32, True, 0.5, False,
                 "fused_weighted"),
    "int8_eval": ("kernel", "graph", torch.float32, False, 0.5, True,
                  "fused_int8"),
    "exact_eval": ("exact", "graph", torch.float32, False, 0.5, True,
                   "composed"),
    "no_edge_drop": ("kernel", "graph", torch.float32, True, 0.0, False,
                     "composed"),
    "int8_with_grad": ("int8", "graph", torch.float32, True, 0.0, False,
                       "composed"),
    "bf16": ("kernel", "graph", torch.bfloat16, True, 0.5, False,
             "composed"),
    "plain_tier": (None, "graph", torch.float32, True, 0.5, False,
                   "composed"),
    "halo_shard": ("kernel", "halo", torch.float32, True, 0.5, False,
                   "composed"),
}


@pytest.mark.parametrize("case", sorted(HOP_PATHS))
def test_hop_counts_follow_the_dispatch(monkeypatch, case):
    """Every hop takes the path `ops.appnp_hop` chooses, and
    `ops.hop_counts` counts it; a halo shard's composed hop is stubbed (its
    sums exchange rows between ranks)."""
    setup, graph, dtype, training, drop, in_eval, path = HOP_PATHS[case]
    if setup is not None:
        monkeypatch.setattr(ops, "_tier_selected", lambda device: True)
    if setup == "exact":
        monkeypatch.setattr(ops, "_EVAL_QUANT", False)
    if setup == "int8":
        ops.set_backend("pallas_int8")
    if graph == "halo":
        g = _halo_shard()
        monkeypatch.setattr(ops, "gcn_norm_both",
                            lambda g, x, edge_weight=None: x * 0.5)
    else:
        g, _ = _skewed(n=600)
    h = torch.randn(g.n_nodes, 8, generator=torch.Generator().manual_seed(1),
                    dtype=dtype).requires_grad_(training)
    ops.reset_counts()
    gen = torch.Generator().manual_seed(2)
    if in_eval:
        with torch.no_grad(), ops.inference_mode():
            out = appnp_propagate(g, h, 10, ALPHA, drop, gen=gen)
    else:
        out = appnp_propagate(g, h, 10, ALPHA, drop, training=training,
                              gen=gen)
        out.float().sum().backward()
    assert out.shape == h.shape
    want = {"fused_weighted": 0, "fused_int8": 0, "composed": 0}
    want[path] = 10
    assert ops.hop_counts == want
    ops.reset_counts()
    assert ops.hop_counts == {k: 0 for k in want}


# ---- the CLIs -------------------------------------------------------------

DATASET = "synth-n512-c5-f32-d8-noise3.0"


def _args(*extra):
    return ["--device", "-1", "--dataset", DATASET, "--max_epoch", "3",
            "--patience", "10", *extra]


def _check_out(path, rows=512, classes=5):
    out = np.load(path)["arr_0"]
    assert out.shape == (rows, classes) and np.isfinite(out).all()
    np.testing.assert_allclose(np.exp(out).sum(1), 1.0, rtol=1e-4)


def _out(root, model):
    return (root / "outputs" / "transductive" / DATASET / model / "seed_0"
            / "out.npz")


@pytest.mark.parametrize("teacher,teacher_pkg,student_pkg", [
    ("GCN", "port", "port"), ("APPNP", "port", "port"),
    ("APPNP", "jax", "port"), ("GCN", "port", "jax")])
def test_teacher_to_student(tmp_path, monkeypatch, capsys, teacher,
                            teacher_pkg, student_pkg):
    from glnn_tpu.cli import train_student as jax_student
    from glnn_tpu.cli import train_teacher as jax_teacher
    from glnn_tpu_torch.cli import train_student, train_teacher

    monkeypatch.chdir(tmp_path)
    (train_teacher if teacher_pkg == "port" else jax_teacher).main(
        _args("--teacher", teacher))
    _check_out(_out(tmp_path, teacher))
    (train_student if student_pkg == "port" else jax_student).main(
        _args("--teacher", teacher, "--student", "MLP"))
    _check_out(_out(tmp_path, f"{teacher}_MLP"))
    scores = [float(s) for s in capsys.readouterr().out.split()]
    assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)
