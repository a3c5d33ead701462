"""The per-edge halo ops and the sharded GAT and APPNP teachers on 4 gloo
ranks (CPU), against `glnn_tpu`'s halo ops on a 4-device mesh of the
conftest's 8 virtual devices (its XLA halo tier) and against the port's
own single-device ops and single-process steps, from the same numpy
inputs and JAX's initial weights.

Per-edge tensors: the port keeps a shard's in its combined CSR's order,
which is the global dst-sorted order sliced at `edge_base`, so the ranks'
tensors concatenated in rank order are the global ones; JAX keeps them in
its shard layout [local slots; halo slots] with ghost slots. The graphs
have no duplicate edges, so (src, dst) names an edge and
`_jax_slot_edges` maps each JAX slot to its global edge.

All port-side cases run in one launch of 4 ranks (`_rank_cases`), shared
by the tests through a module fixture. JAX is imported only inside the
fixtures and tests, so that the ranks, which import this module, never
load it."""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from glnn_tpu_torch import ops
from glnn_tpu_torch.distributed import mesh, runners
from glnn_tpu_torch.distributed.halo import (
    build_halo_graph,
    halo_edge_softmax,
    halo_gat_attention,
    halo_u_add_v,
    halo_u_mul_e_sum,
    shard_rows,
)
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn.convert import from_jax_variables
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.ops import gat_cuda, spmm_cuda
from glnn_tpu_torch.train import make_adam, make_gnn_train_step

P = 4
LR, WD = 0.01, 0.0005
OPS = dict(n=203, e=1600, seed=21)          # n_pad 204: one ghost row
STEP = dict(n=256, e=2400, f=12, c=5, seed=23)
H, D = 2, 4                                  # the ops' heads and width
SEED = 0x5EED_1234_ABCD                      # the attention dropout seed


def _unique_edges(n, e, seed):
    """e distinct (src, dst) pairs over n nodes, in random order."""
    rs = np.random.RandomState(seed)
    pairs = rs.choice(n * n, e, replace=False)
    return (pairs // n).astype(np.int64), (pairs % n).astype(np.int64), rs


def _gat_conf(dropout=0.0, attn=0.0):
    return dict(model_name="GAT", num_layers=2, hidden_dim=16, num_heads=2,
                feat_dim=STEP["f"], label_dim=STEP["c"],
                dropout_ratio=dropout, attn_dropout_ratio=attn)


def _appnp_conf(dropout=0.0):
    return dict(model_name="APPNP", num_layers=2, hidden_dim=16,
                feat_dim=STEP["f"], label_dim=STEP["c"],
                dropout_ratio=dropout, norm_type="none")


def _port_model(conf, variables, edge_drop=None):
    model = Model(conf)
    from_jax_variables(variables, model)
    if edge_drop is not None:
        model.module.edge_drop = edge_drop
    return model


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _gather_edges(t: torch.Tensor) -> np.ndarray:
    """The ranks' per-edge tensors in rank order: the global edge order."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, t.detach().numpy())
    return np.concatenate(parts)


def _summed(t: torch.Tensor) -> np.ndarray:
    return mesh.all_reduce_(t.detach().clone()).numpy()


# ---------------------------------------------------------------------------
# the port's side, run on every rank
# ---------------------------------------------------------------------------

def _op_cases(r, pl, kernel):
    """Every halo op's forward and gradients on this rank's shard, with the
    f32 plain tier (kernel False) or the kernel tier's plain versions."""
    hg = pl["ops_hg"]
    rows, lo, n_e = hg.rows, hg.edge_base, hg.n_edges

    def rows_of(name):
        return torch.from_numpy(shard_rows(pl[name], P, r))

    def edges_of(name):
        return torch.from_numpy(pl[name][lo:lo + n_e].copy())

    res = {}
    if not kernel:
        a_u, a_v = (rows_of(k).requires_grad_() for k in ("a_u", "a_v"))
        out = halo_u_add_v(hg, a_u, a_v)
        (out * edges_of("co_e3")).sum().backward()
        res["u_add_v"] = (_gather_edges(out), mesh.all_gather_rows(a_u.grad),
                          mesh.all_gather_rows(a_v.grad))
    for tag, name, co in (("softmax_1", "s1", "co_e1"),
                          ("softmax_3", "s3", "co_e3")):
        s = edges_of(name).requires_grad_()
        out = halo_edge_softmax(hg, s, kernel=kernel)
        (out * edges_of(co)).sum().backward()
        res[tag] = (_gather_edges(out), _gather_edges(s.grad))
    for tag, xn, wn, co in (("wsum_2d", "x2", "w1", "co_x2"),
                            ("wsum_3d", "x3", "w2", "co_x3")):
        x, w = rows_of(xn).requires_grad_(), edges_of(wn).requires_grad_()
        out = halo_u_mul_e_sum(hg, x, w, kernel=kernel)
        (out * rows_of(co)).sum().backward()
        res[tag] = (mesh.all_gather_rows(out.detach()),
                    mesh.all_gather_rows(x.grad), _gather_edges(w.grad))
    drops = (None,) if not kernel else (None, torch.tensor([SEED]))
    for keep in drops:
        feat = rows_of("x3").requires_grad_()
        al, ar = (torch.from_numpy(pl[k]).requires_grad_()
                  for k in ("attn_l", "attn_r"))
        if kernel:
            out = halo_gat_attention(hg, feat, al, ar, 0.2, keep,
                                     1.0 / 0.7 if keep is not None else 1.0)
        else:
            ops.set_backend("xla")
            out = ops.gat_attention(hg, feat, al, ar)
            ops.set_backend("auto")
        (out * rows_of("co_x3")).sum().backward()
        res[f"gat_{'seed' if keep is not None else 'none'}"] = (
            mesh.all_gather_rows(out.detach()),
            mesh.all_gather_rows(feat.grad), _summed(al.grad),
            _summed(ar.grad))
    return res


def _step(model, hg, pl, r):
    runners._sync_batch_norm(model, True)
    opt = make_adam(model.parameters(), LR, WD)
    loss = runners.make_halo_train_step(model, opt)(
        hg, torch.from_numpy(shard_rows(pl["step_x"], P, r)),
        torch.from_numpy(pl["step_labels"]),
        torch.from_numpy(pl["step_idx"]), torch.Generator().manual_seed(7))
    return loss, _state(model)


def _rank_cases(m, pl):
    """Every port-side case on this rank; rank 0 returns the results."""
    r = m.rank
    res = {"jax_loaded": any(k.split(".")[0] in ("jax", "jaxlib", "glnn_tpu")
                             for k in sys.modules)}
    res["plain"] = _op_cases(r, pl, kernel=False)
    res["kernel"] = _op_cases(r, pl, kernel=True)

    hg = pl["step_hg"]
    res["gat_step"] = _step(_port_model(_gat_conf(), pl["gat_vars"]), hg,
                            pl, r)
    res["appnp_step"] = _step(_port_model(_appnp_conf(), pl["appnp_vars"],
                                          edge_drop=0.0), hg, pl, r)
    for tier in ("xla", "pallas"):
        ops.set_backend(tier)
        res[f"gat_drop_{tier}"] = _step(_port_model(
            _gat_conf(0.5, 0.3), pl["gat_vars"]), hg, pl, r)
        ops.set_backend("auto")
    res["appnp_drop"] = _step(_port_model(_appnp_conf(0.5), pl["appnp_vars"]),
                              hg, pl, r)
    return res if r == 0 else None


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax4():
    import jax

    from glnn_tpu.distributed.mesh import make_mesh

    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    return make_mesh(P, axis="graph")


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs (per-edge ones in global dst-sorted order), and
    JAX's initial weights of the two teachers."""
    import jax
    import jax.numpy as jnp

    from glnn_tpu.graph.container import build_graph as jax_build_graph
    from glnn_tpu.nn.models import Model as JaxModel

    src, dst, rs = _unique_edges(OPS["n"], OPS["e"], OPS["seed"])
    n_pad, e = P * -(-OPS["n"] // P), OPS["e"]

    def randn(*shape):
        return rs.randn(*shape).astype(np.float32)

    pl = dict(ops_src=src, ops_dst=dst, a_u=randn(OPS["n"], 3),
              a_v=randn(OPS["n"], 3), s1=randn(e) * 3, s3=randn(e, 3) * 3,
              co_e1=randn(e), co_e3=randn(e, 3), x2=randn(OPS["n"], 6),
              x3=randn(OPS["n"], H, D), w1=rs.uniform(0, 2, e).astype(
                  np.float32), w2=rs.uniform(0, 1, (e, H)).astype(np.float32),
              co_x2=randn(n_pad, 6), co_x3=randn(n_pad, H, D),
              attn_l=randn(H, D), attn_r=randn(H, D))

    src, dst, rs = _unique_edges(STEP["n"], STEP["e"], STEP["seed"])
    x = rs.randn(STEP["n"], STEP["f"]).astype(np.float32)
    pl.update(step_src=src, step_dst=dst, step_x=x,
              step_labels=rs.randint(0, STEP["c"], STEP["n"]),
              step_idx=rs.choice(STEP["n"], 60, replace=False))
    gj = jax_build_graph(src, dst, STEP["n"])
    for name, conf in (("gat", _gat_conf()), ("appnp", _appnp_conf())):
        pl[f"{name}_vars"] = jax.tree_util.tree_map(np.asarray, JaxModel(
            conf).init(jax.random.PRNGKey(0), gj, jnp.asarray(x)))
    return pl


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results of `_rank_cases` on 4 gloo ranks."""
    shards = {k: build_halo_graph(inputs[f"{k}_src"], inputs[f"{k}_dst"],
                                  STEP["n"] if k == "step" else OPS["n"], P,
                                  combined=True) for k in ("ops", "step")}
    payloads = [dict(inputs, ops_hg=shards["ops"][r],
                     step_hg=shards["step"][r]) for r in range(P)]
    return mesh.launch(_rank_cases, payloads, -1, timeout=300)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _edge_ids(src, dst, n, s, d):
    """Global dst-sorted ids of the edges (s, d) of the graph (src, dst)."""
    g = build_graph(src, dst, n)
    keys = g.senders.numpy().astype(np.int64) * n + g.receivers.numpy()
    order = np.argsort(keys)
    return order[np.searchsorted(keys[order], s * n + d)]


def _jax_slot_edges(hj, src, dst, n):
    """The global edge id of each slot of JAX's shard layout
    [P * (e_local + e_halo)], -1 for a ghost slot."""
    rows, el, eh, h = hj.rows_per_shard, hj.e_local, hj.e_halo, hj.halo_rows
    lsrc, ldst = np.asarray(hj.local_src), np.asarray(hj.local_dst)
    hgat, hdst = np.asarray(hj.halo_gather), np.asarray(hj.halo_dst)
    send = np.asarray(hj.send_idx)
    ids = np.full((P, el + eh), -1, np.int64)
    for p in range(P):
        base = p * rows
        real = ldst[p] < rows
        ids[p, :el][real] = _edge_ids(src, dst, n, lsrc[p][real] + base,
                                      ldst[p][real] + base)
        real = hdst[p] < rows
        q, k = hgat[p][real] // h, hgat[p][real] % h
        ids[p, el:][real] = _edge_ids(src, dst, n, send[q, p, k] + q * rows,
                                      hdst[p][real] + base)
    return ids.reshape(-1)


def _to_slots(v, ids):
    """A global per-edge array in JAX's shard layout (ghost slots 0)."""
    import jax.numpy as jnp

    out = v[np.maximum(ids, 0)]
    out[ids < 0] = 0
    return jnp.asarray(out)


@pytest.fixture(scope="module")
def jax_ops(inputs, jax4):
    """JAX's halo ops on the same inputs: forwards and gradients, per-edge
    ones mapped back to the global edge order."""
    import jax
    import jax.numpy as jnp

    from glnn_tpu.distributed import halo as jh

    src, dst, n = inputs["ops_src"], inputs["ops_dst"], OPS["n"]
    hj = jh.build_halo_graph(src, dst, n, jax4)
    ids = _jax_slot_edges(hj, src, dst, n)
    real = ids >= 0
    order = ids[real]

    def edges(a):
        out = np.zeros(a.shape, np.float32)[: len(order)]
        out[order] = np.asarray(a)[real]
        return out

    def rows(name):
        return jh.shard_features(inputs[name], hj)

    slots = {k: _to_slots(inputs[k], ids)
             for k in ("s1", "s3", "co_e1", "co_e3", "w1", "w2")}
    want = {}
    f = jax.jit(lambda a, b: jh.halo_u_add_v(hj, a, b))
    out = f(rows("a_u"), rows("a_v"))
    grads = jax.grad(lambda a, b: (f(a, b) * slots["co_e3"]).sum(),
                     (0, 1))(rows("a_u"), rows("a_v"))
    want["u_add_v"] = (edges(out), *map(np.asarray, grads))
    for tag, name, co in (("softmax_1", "s1", "co_e1"),
                          ("softmax_3", "s3", "co_e3")):
        f = jax.jit(lambda s: jh.halo_edge_softmax(hj, s))
        grad = jax.grad(lambda s: (f(s) * slots[co]).sum())(slots[name])
        want[tag] = (edges(f(slots[name])), edges(grad))
    for tag, xn, wn, co in (("wsum_2d", "x2", "w1", "co_x2"),
                            ("wsum_3d", "x3", "w2", "co_x3")):
        f = jax.jit(lambda x, w: jh.halo_u_mul_e_sum(hj, x, w))
        cot = jnp.asarray(inputs[co])
        gx, gw = jax.grad(lambda x, w: (f(x, w) * cot).sum(), (0, 1))(
            rows(xn), slots[wn])
        want[tag] = (np.asarray(f(rows(xn), slots[wn])), np.asarray(gx),
                     edges(gw))
    f = jax.jit(lambda x, a, b: jh.halo_gat_attention(hj, x, a, b,
                                                      fused=False))
    args = (rows("x3"), jnp.asarray(inputs["attn_l"]),
            jnp.asarray(inputs["attn_r"]))
    cot = jnp.asarray(inputs["co_x3"])
    grads = jax.grad(lambda *a: (f(*a) * cot).sum(), (0, 1, 2))(*args)
    want["gat_none"] = (np.asarray(f(*args)), *map(np.asarray, grads))
    return want


def _close(got, want, rtol=1e-5, atol=1e-5):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_never_load_jax(port):
    assert not port["jax_loaded"]


@pytest.mark.parametrize("op", ["u_add_v", "softmax_1", "softmax_3",
                                "wsum_2d", "wsum_3d", "gat_none"])
def test_halo_op_matches_jax(port, jax_ops, op):
    """Forward and every gradient of the f32 plain tier against JAX's XLA
    halo tier (the GAT layer without dropout; ghost rows included)."""
    _close(port["plain"][op], jax_ops[op])


@pytest.mark.parametrize("op", ["softmax_1", "softmax_3", "wsum_2d",
                                "wsum_3d", "gat_none", "gat_seed"])
def test_halo_kernel_tier_matches_single_device(port, inputs, op):
    """The kernel tier's halo ops (their plain versions here) against the
    single-device kernel tier on the same graph: the same bf16 rounding,
    summed in another order; in seed mode the same keep bits (edge_base)."""
    n = OPS["n"]
    g = build_graph(inputs["ops_src"], inputs["ops_dst"], n)

    def t(name, grad=True):
        return torch.from_numpy(inputs[name].copy()).requires_grad_(grad)

    def co(name):
        return torch.from_numpy(inputs[name][:n])

    got = port["kernel"][op]
    if op.startswith("softmax"):
        s = t("s1" if op == "softmax_1" else "s3")
        out = gat_cuda.edge_softmax(g, s)
        (out * t("co_e1" if op == "softmax_1" else "co_e3", False)
         ).sum().backward()
        want = (out, s.grad)
    elif op.startswith("wsum"):
        x, w = (t("x2"), t("w1")) if op == "wsum_2d" else (t("x3"), t("w2"))
        out = spmm_cuda.u_mul_e_sum(g, x, w)
        (out * co("co_x2" if op == "wsum_2d" else "co_x3")).sum().backward()
        want = (out, x.grad, w.grad)
        got = (got[0][:n], got[1][:n], got[2])
    else:
        feat, al, ar = t("x3"), t("attn_l"), t("attn_r")
        keep = torch.tensor([SEED]) if op == "gat_seed" else None
        out = gat_cuda.gat_attention(g, feat, al, ar, 0.2, keep,
                                     1.0 / 0.7 if keep is not None else 1.0)
        (out * co("co_x3")).sum().backward()
        want = (out, feat.grad, al.grad, ar.grad)
        got = (got[0][:n], got[1][:n], got[2], got[3])
    _close(got, [w.detach().numpy() for w in want], rtol=1e-4, atol=1e-5)


def test_gat_seed_mode_drops_edges(port):
    """The seed actually drops: with it the layer differs from without."""
    assert not np.allclose(port["kernel"]["gat_seed"][0],
                           port["kernel"]["gat_none"][0], atol=1e-3)


def _jax_step(inputs, jax4, conf, variables, edge_drop=None):
    import jax
    import jax.numpy as jnp

    from glnn_tpu.distributed.halo import build_halo_graph as jax_halo
    from glnn_tpu.distributed.halo import shard_features
    from glnn_tpu.nn.models import Model as JaxModel
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_adam
    from glnn_tpu.train import make_gnn_train_step as jax_step

    hg = jax_halo(inputs["step_src"], inputs["step_dst"], STEP["n"], jax4)
    jm = JaxModel(conf)
    if edge_drop is not None:
        jm.module = jm.module.clone(edge_drop=edge_drop)
    opt = jax_adam(LR, WD)
    state, loss = jax_step(jm, opt)(
        create_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                           opt), hg,
        shard_features(inputs["step_x"], hg),
        jnp.asarray(inputs["step_labels"]), jnp.asarray(inputs["step_idx"]),
        jax.random.PRNGKey(1))
    want = _state(_port_model(conf, jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})))
    return float(loss), want


def _assert_step(got, want_loss, want, rtol=1e-4, atol=1e-5):
    got_loss, got_state = got
    assert abs(got_loss - want_loss) < 1e-5
    assert got_state.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got_state[k], want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("teacher", ["GAT", "APPNP"])
def test_halo_step_matches_jax(port, inputs, jax4, teacher):
    """One halo training step from JAX's initial weights, dropout (and
    APPNP's edge drop) off on both sides: the loss and every updated
    parameter."""
    if teacher == "GAT":
        loss, want = _jax_step(inputs, jax4, _gat_conf(), inputs["gat_vars"])
        _assert_step(port["gat_step"], loss, want)
    else:
        loss, want = _jax_step(inputs, jax4, _appnp_conf(),
                               inputs["appnp_vars"], edge_drop=0.0)
        _assert_step(port["appnp_step"], loss, want)


@pytest.mark.parametrize("case", ["gat_drop_xla", "gat_drop_pallas",
                                  "appnp_drop"])
def test_halo_step_with_dropout_matches_single_process(port, inputs, case):
    """Feature dropout 0.5 with attention dropout 0.3 (GAT, on the f32
    tier and on the fused kernels' plain versions) or edge drop 0.5
    (APPNP): every rank draws the global masks and the one Philox seed from
    a generator seeded alike, and keeps its rows and its edges' slice (the
    fused kernels through edge_base), so the step is the single-process
    step from the same generator (n = n_pad: the row masks agree)."""
    n = STEP["n"]
    g = build_graph(inputs["step_src"], inputs["step_dst"], n)
    if case.startswith("gat"):
        model = _port_model(_gat_conf(0.5, 0.3), inputs["gat_vars"])
        ops.set_backend(case.split("_")[-1])
    else:
        model = _port_model(_appnp_conf(0.5), inputs["appnp_vars"])
    try:
        loss = make_gnn_train_step(model, make_adam(model.parameters(), LR,
                                                    WD))(
            g, torch.from_numpy(inputs["step_x"]),
            torch.from_numpy(inputs["step_labels"]),
            torch.from_numpy(inputs["step_idx"]),
            torch.Generator().manual_seed(7))
    finally:
        ops.set_backend("auto")
    _assert_step(port[case], float(loss), _state(model))
    # the dropout moved the step: it differs from the dropout-free one
    free = port["appnp_step" if case == "appnp_drop" else "gat_step"][1]
    assert not all(np.allclose(free[k], port[case][1][k], atol=1e-6)
                   for k in free)


def test_combined_csr_is_the_global_edge_order():
    """Over the shards, the combined CSR with its sources mapped back to
    global ids is build_graph's indptr and senders exactly; edge_base is
    each shard's first global edge; the transpose holds each edge once,
    stable by edge within a source row."""
    src, dst, _ = _unique_edges(150, 1100, 5)
    src = np.concatenate([src, src[:40]])            # and some multi-edges
    dst = np.concatenate([dst, dst[:40]])
    n = 150
    g = build_graph(src, dst, n)
    shards = build_halo_graph(src, dst, n, P, combined=True)
    rows = shards[0].rows
    sends = [np.split(s.send_idx.numpy() + s.rank * rows,
                      np.cumsum(s.send_splits)[:-1]) for s in shards]
    senders, indptr_ok = [], True
    for p, s in enumerate(shards):
        recv = np.concatenate([sends[q][p] for q in range(P)]).astype(
            np.int64)
        c = s.c_indices.numpy().astype(np.int64)
        senders.append(np.where(c < rows, c + p * rows,
                                recv[np.maximum(c - rows, 0)]))
        base = p * rows
        top = min(base + rows, n)
        want = g.indptr.numpy()[base:top + 1].astype(np.int64)
        indptr_ok &= s.edge_base == int(want[0])
        indptr_ok &= np.array_equal(s.c_indptr.numpy()[:top - base + 1]
                                    + s.edge_base, want)
        assert s.n_edges_global == g.n_edges and s.n_edges == c.shape[0]
        np.testing.assert_array_equal(
            s.c_dst.numpy(), np.repeat(np.arange(rows),
                                       np.diff(s.c_indptr.numpy())))
        t_edges = s.c_t_edges.numpy()
        assert sorted(t_edges.tolist()) == list(range(s.n_edges))
        t_rows = np.repeat(np.arange(rows + s.n_recv),
                           np.diff(s.c_t_indptr.numpy()))
        np.testing.assert_array_equal(c[t_edges], t_rows)
        np.testing.assert_array_equal(s.c_dst.numpy()[t_edges],
                                      s.c_t_dst.numpy())
        for row in np.unique(t_rows):
            assert np.all(np.diff(t_edges[t_rows == row]) > 0)
    assert indptr_ok
    np.testing.assert_array_equal(np.concatenate(senders),
                                  g.senders.numpy())


@pytest.mark.parametrize("base", [0, 1, 37, 2 ** 32 - 5])
def test_philox_keep_edge_base_is_a_slice(base):
    """philox_keep at edge_base b equals rows b.. of the unbased mask, and
    row e its mask at edge_base b + e (the counter wraps at 2**32)."""
    seed, n, wrap = torch.tensor([SEED]), 64, 2 ** 32
    based = gat_cuda.philox_keep(seed, n, 5, 0.6, edge_base=base)
    if base + n <= wrap:
        assert torch.equal(based, gat_cuda.philox_keep(
            seed, base + n, 5, 0.6)[base:]) if base < 4096 else True
    else:
        assert torch.equal(based[wrap - base:], gat_cuda.philox_keep(
            seed, base + n - wrap, 5, 0.6))
    for e in (0, n // 2, n - 1):
        assert torch.equal(based[e:e + 1], gat_cuda.philox_keep(
            seed, 1, 5, 0.6, edge_base=(base + e) % wrap))
