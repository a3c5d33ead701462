"""The port's APPNP teacher against a plain APPNP written here from its
definition (plain torch, nothing of the port), on the CPU at a small size.

The graph has reverse edges and self-loops, as ogbn-arxiv's, and rows
past the hub chunk (spmm_cuda.HUB_CHUNK) in both walks. Weights are the
port's own seeded initial draws; the port and the plain APPNP draw their
dropout and edge-drop masks from generators seeded alike.

Tolerances (largest |port - plain| over the largest |plain|):
* the kernel tier's plain versions (ops._tier_selected forced on): both
  sides round each message once to bf16 from the same f32 product, sum
  in f32 and quantise the eval alike; they differ at most in the order
  of f32 sums and operations, so logits, losses, the int8 eval and three
  Adam steps agree to RTOL_KERNEL;
* the plain tier (f32 messages) against the plain APPNP's bf16 messages:
  each message differs by at most 2^-9 of itself and the hops average
  them, so the logits stay within RTOL_PLAIN, 4 x 2^-9.
The planted faults (teleport 0.2 for 0.1, 9 hops for 10) move the training
logits by 8-16% of their largest, outside both; the eval, near APPNP's
fixed point, moves by 4e-4 or more under 9 hops, well outside the kernel
tier's."""

import collections
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from glnn_tpu.nn.models import APPNP as JaxAPPNP
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.ops import spmm_cuda
from glnn_tpu_torch.train import engine
from glnn_tpu_torch.train.state import make_adam
from glnn_tpu_torch.utils import profiling

N, F_IN, CLASSES = 1200, 16, 5
HUBS = (600, 1100)                   # in-edges of nodes 0 and 1
RTOL_KERNEL = 1e-5
RTOL_PLAIN = 4 * 2.0 ** -9
# GLNN's APPNP row: a 2-layer MLP head, then K hops with teleport ALPHA
# and edge drop EDGE_DROP (the port's and JAX's constants)
HIDDEN, DROPOUT, LR, WD = 32, 0.5, 0.01, 0.01
K, ALPHA, EDGE_DROP = 10, 0.1, 0.5
CONF = {"model_name": "APPNP", "num_layers": 2, "hidden_dim": HIDDEN,
        "feat_dim": F_IN, "label_dim": CLASSES, "dropout_ratio": DROPOUT,
        "norm_type": "none"}
FAULTS = {"alpha": {"alpha": 0.2}, "hops": {"k": 9}}
SEED = 21


# ---- the plain APPNP ----------------------------------------------------------

class PlainGraph(NamedTuple):
    """Edges sorted by destination, stably (the port's edge order, over
    which both sides draw the [E] masks), and both degree vectors."""
    src: torch.Tensor
    dst: torch.Tensor
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    n: int


def _plain_graph(src, dst, n):
    order = np.argsort(dst, kind="stable")
    s, d = torch.from_numpy(src[order]), torch.from_numpy(dst[order])
    return PlainGraph(s, d, torch.bincount(d, minlength=n).float(),
                      torch.bincount(s, minlength=n).float(), n)


def _segment_sum(values, index, n):
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add_(
        0, index, values)


class _Bf16WeightedSum(torch.autograd.Function):
    """out[v] = sum over v's in-edges of bf16(x[src] w), in f32; the
    backward sums bf16(dout[dst] w) over each source's out-edges."""

    @staticmethod
    def forward(ctx, x, w, g):
        ctx.save_for_backward(w)
        ctx.g = g
        msg = (x[g.src] * w[:, None]).bfloat16().float()
        return _segment_sum(msg, g.dst, g.n)

    @staticmethod
    def backward(ctx, dout):
        w, = ctx.saved_tensors
        g = ctx.g
        msg = (dout[g.dst] * w[:, None]).bfloat16().float()
        return _segment_sum(msg, g.src, g.n), None, None


def _int8_sum(x, g):
    """x quantised per column (absmax / 127, half to even), the int8 rows
    summed exactly over each row's in-edges, dequantised once."""
    scale = x.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    return _segment_sum(q[g.src], g.dst, g.n).float() * scale


def plain_appnp(p, g, x, train, gen, k=K, alpha=ALPHA):
    """Logits: h0 = linear, relu, dropout (one [N, HIDDEN] draw), linear;
    then k hops of h <- (1 - alpha) D_in^-1/2 A_w D_out^-1/2 h + alpha h0,
    A_w keeping each edge where an [E] draw is >= EDGE_DROP and scaling it
    by 1 / (1 - EDGE_DROP) in training (bf16 messages, f32 sums), and an
    int8 hop in evals."""
    h = torch.relu(F.linear(x, p["module.layers.0.weight"],
                            p["module.layers.0.bias"]))
    if train:
        keep = torch.rand(h.shape, generator=gen) >= DROPOUT
        h = h * keep.float() / (1.0 - DROPOUT)
    h0 = h = F.linear(h, p["module.layers.1.weight"],
                      p["module.layers.1.bias"])
    src_norm = torch.rsqrt(g.out_deg.clamp(min=1.0))[:, None]
    dst_norm = torch.rsqrt(g.in_deg.clamp(min=1.0))[:, None]
    for _ in range(k):
        xs = h * src_norm
        if train:
            w = (torch.rand((g.src.shape[0],), generator=gen)
                 >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
            prop = _Bf16WeightedSum.apply(xs, w, g)
        else:
            prop = _int8_sum(xs, g)
        h = (1.0 - alpha) * (prop * dst_norm) + alpha * h0
    return h


def _nll(logits, rows, y):
    return -torch.log_softmax(logits, dim=-1)[rows].gather(
        1, y[:, None]).mean()


# ---- the case -----------------------------------------------------------------

def _edges():
    """Directed edges, two hub rows past the chunk, then their reverses
    and a self-loop per node (int64 src, dst)."""
    rs = np.random.RandomState(SEED)
    src = [rs.randint(2, N, 4000)]
    dst = [rs.randint(2, N, 4000)]
    for node, deg in enumerate(HUBS):
        src.append(rs.choice(np.arange(2, N), deg, replace=False))
        dst.append(np.full(deg, node))
    s, d = np.concatenate(src), np.concatenate(dst)
    loops = np.arange(N)
    return (np.concatenate([s, d, loops]), np.concatenate([d, s, loops]))


@pytest.fixture(scope="module")
def case():
    src, dst = _edges()
    g = build_graph(src, dst, N)
    plain = _plain_graph(src, dst, N)
    rs = np.random.RandomState(SEED + 1)
    feats = torch.from_numpy(rs.randn(N, F_IN).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, CLASSES, N))
    idx = torch.from_numpy(rs.permutation(N)[:3 * 300].reshape(3, 300))
    return g, plain, feats, labels, idx


@pytest.fixture()
def kernel_tier(monkeypatch):
    monkeypatch.setattr(ops, "_tier_selected", lambda device: True)


def _model(**fault):
    """The port's model from its seeded draw; a planted fault is set on
    the built module."""
    model = Model(CONF, torch.Generator().manual_seed(SEED))
    for key, value in fault.items():
        setattr(model.module, key, value)
    return model


def _gen():
    return torch.Generator().manual_seed(SEED + 2)


def _gap(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _train_logits(g, plain, feats, **fault):
    """(port, plain) training-mode logits from one seeded draw each; the
    plain APPNP takes the port's initial weights."""
    model = _model(**fault).train()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    port = model(g, feats, _gen())[1].detach()
    return port, plain_appnp(state, plain, feats, True, _gen()).detach()


def test_the_graph_has_hub_rows_in_both_walks(case):
    g, plain, *_ = case
    n = g.n_nodes
    assert spmm_cuda.plan_of(g, "indptr", n).n_chunks > 0
    assert spmm_cuda.plan_of(g, "t_indptr", n).n_chunks > 0
    # the port walks the edges in the plain APPNP's order, so an [E] draw
    # masks the same edge on both sides
    assert torch.equal(g.senders.long(), plain.src)
    assert torch.equal(g.receivers.long(), plain.dst)
    # every reverse edge is present: DGL's in-degree norm on both sides
    # equals the port's out-degree norm on the source side
    assert torch.equal(plain.in_deg, plain.out_deg)


@pytest.mark.parametrize("tier", ["plain", "kernel"])
def test_training_logits_and_loss_match_the_reference(case, tier,
                                                      monkeypatch):
    g, plain, feats, labels, idx = case
    if tier == "kernel":
        monkeypatch.setattr(ops, "_tier_selected", lambda device: True)
    tol = RTOL_KERNEL if tier == "kernel" else RTOL_PLAIN
    port, want = _train_logits(g, plain, feats)
    assert _gap(port, want) <= tol
    rows, y = idx[0], labels[idx[0]]
    lp, lr = _nll(port, rows, y), _nll(want, rows, y)
    assert abs(float(lp - lr)) <= tol * abs(float(lr))


def test_three_adam_steps_match_the_reference(case, kernel_tier):
    g, plain, feats, labels, idx = case
    model = _model()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = engine.make_gnn_train_step(model,
                                      make_adam(model.parameters(), LR, WD))
    gen = _gen()
    losses = [float(step(g, feats, labels, idx[0], gen)) for _ in range(3)]
    p = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    opt = torch.optim.Adam(p.values(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=WD)
    gen = _gen()
    for got in losses:
        loss = _nll(plain_appnp(p, plain, feats, True, gen), idx[0],
                    labels[idx[0]])
        opt.zero_grad()
        loss.backward()
        opt.step()
        want = float(loss.detach())
        assert abs(got - want) <= RTOL_KERNEL * abs(want)
    for k, v in model.state_dict().items():
        assert _gap(v - start[k], p[k].detach() - start[k]) <= RTOL_KERNEL, k


def _eval_pair(g, plain, feats, **fault):
    model = _model(**fault)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    port = engine.make_eval_fn(model)(g, feats)
    want = torch.log_softmax(plain_appnp(state, plain, feats, False, None),
                             dim=-1)
    return port, want


def test_int8_eval_matches_the_reference_int8_hops(case, kernel_tier):
    """The runner's eval on the kernel tier takes the int8 hops; the
    plain APPNP's eval quantises each hop alike."""
    g, plain, feats, *_ = case
    port, want = _eval_pair(g, plain, feats)
    assert _gap(port, want) <= RTOL_KERNEL
    # and the int8 hops are not the exact ones: the f32 forward moves it
    exact = engine.make_eval_fn(_model(), exact=True)(g, feats)
    assert _gap(exact, want) > 10 * RTOL_KERNEL


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(case, kernel_tier, fault):
    g, plain, feats, *_ = case
    port, want = _train_logits(g, plain, feats, **FAULTS[fault])
    assert _gap(port, want) > RTOL_PLAIN
    port, want = _eval_pair(g, plain, feats, **FAULTS[fault])
    assert _gap(port, want) > 10 * RTOL_KERNEL


# each span of an APPNP epoch, with the spans it may lie in (None: a root)
EPOCH_PARENTS = {
    "runner.train_epoch": None,
    "runner.forward": {"runner.train_epoch"},
    "runner.backward": {"runner.train_epoch"},
    "runner.optimizer": {"runner.train_epoch"},
    "model.APPNP.layer0": {"runner.forward", "runner.eval"},
    "model.APPNP.layer1": {"runner.forward", "runner.eval"},
    "model.APPNP.propagate": {"runner.forward", "runner.eval"},
    "model.APPNP.edge_drop": {"model.APPNP.propagate"},
    "kernel.spmm_csr_weighted": {"model.APPNP.propagate", "runner.backward"},
    "kernel.spmm_csr_int8": {"model.APPNP.propagate"},
    "runner.eval": None,
    "runner.metrics_row": None,
    "runner.host_read": {"runner.train_epoch", "runner.metrics_row"},
}


def test_spans_nest_and_hops_count_ten_and_ten(case, kernel_tier,
                                               monkeypatch):
    """An epoch's spans nest as EPOCH_PARENTS says, and count its hops:
    10 weighted (one mask draw each) and their 10 transposed walks in the
    step, 10 int8 in the eval."""
    import logging

    g, _, feats, labels, idx = case
    monkeypatch.setattr(profiling, "_log", profiling.SpanLog())
    model = _model()
    opt = make_adam(model.parameters(), LR, WD)
    train = engine._teacher_epoch_fn(CONF, model, opt, logging.getLogger(),
                                     g, feats, labels, idx[0], _gen())
    evaluate = engine.make_eval_fn(model)

    def epoch(i):
        train(i)
        out = evaluate(g, feats)
        engine._metrics_row((out, labels, ix) for ix in idx)

    epoch(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        epoch(2)
    recs = profiling.span_records()
    by_id = {r.id: r for r in recs}
    assert {r.name for r in recs} == set(EPOCH_PARENTS)
    for r in recs:
        want = EPOCH_PARENTS[r.name]
        if want is None:
            assert r.parent == -1 and r.root == r.id, r
            continue
        if r.parent == -1:       # a backward span on autograd's thread
            assert "runner.backward" in want and by_id[r.root].name == \
                "runner.train_epoch", r
            continue
        parent = by_id[r.parent]
        assert parent.name in want, r
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    calls = collections.Counter(r.name for r in recs)
    assert calls["model.APPNP.propagate"] == 2
    assert calls["model.APPNP.edge_drop"] == 10
    assert calls["kernel.spmm_csr_weighted"] == 20
    assert calls["kernel.spmm_csr_int8"] == 10


@pytest.mark.parametrize("extra", [
    {},
    {"k": 3, "alpha": 0.25, "edge_drop": 0.2},
    {"alpha": 0.3},
])
def test_model_keeps_the_jax_appnp_constants(extra):
    """Model builds APPNP with the JAX package's k, alpha and edge drop
    (GLNN's APPNPConv(k=10, alpha=0.1, edge_drop=0.5)), whatever else the
    conf carries, as the JAX Model does."""
    m = Model(dict(CONF, **extra)).module
    want = (JaxAPPNP.k, JaxAPPNP.alpha, JaxAPPNP.edge_drop)
    assert (m.k, m.alpha, m.edge_drop) == want == (K, ALPHA, EDGE_DROP)
