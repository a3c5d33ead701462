"""The port's inductive setting and the --feature_aug_k / --compute_min_cut
pieces against glnn_tpu, on the same numpy inputs
(synth-n512-c5-f32-d8-noise3.0 and seeded numpy arrays).

Tolerances:
* split and subgraph arrays: exactly equal (the same numpy calls; the
  subgraph on both tiers of the host-graph library, `tier`);
* feature_prop: rtol 1e-5 / atol 1e-6 (f32 segment sums on both sides, in
  another order);
* the min-cut loss: rtol 1e-5 (f32 sums of the same products);
* the runners: JAX's initial weights carried over through
  `nn/convert.py`, dropout 0 and one batch holding every training row, so
  that no random draw reaches the result; f32 on both sides with exact
  evals (JAX on the CPU takes its f32 XLA tier, the port its plain f32
  tier), out at rtol 1e-4 / atol 1e-5 after five Adam epochs; the scores
  (accuracies k / n over at most 512 nodes) at rtol 1e-6, which is below
  1 / n, so the counts of right answers are equal: only the f32 rounding
  of the division may differ.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.graph.datasets import load_data as jax_load_data
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu.ops import graph_utils as jax_graph_utils
from glnn_tpu.train.engine import distill_run_inductive as jax_distill_ind
from glnn_tpu.train.engine import run_inductive as jax_run_inductive
from glnn_tpu.train.state import make_adam as jax_make_adam
from glnn_tpu.utils import splits as jax_splits
from glnn_tpu_torch.cli.common import propagate_features
from glnn_tpu_torch.graph.datasets import load_data
from glnn_tpu_torch.nn import Model, from_jax_variables
from glnn_tpu_torch.ops import graph_utils, refops, spmm_cuda
from glnn_tpu_torch.train import (distill_run_inductive, make_adam,
                                  make_eval_fn, run_inductive)
from glnn_tpu_torch.utils import splits
from native_tiers import tier  # noqa: F401  (fixture: native, numpy)

DATASET = "synth-n512-c5-f32-d8-noise3.0"
LOGGER = logging.getLogger("test_torch_inductive")


def _data():
    """The port's and JAX's loads of the synth dataset (they must agree)."""
    g, labels, *idx = load_data(DATASET, "./data", seed=0)
    gj, labels_j, *idx_j = jax_load_data(DATASET, "./data", seed=0)
    np.testing.assert_array_equal(g.src, gj.src)
    np.testing.assert_array_equal(g.dst, gj.dst)
    np.testing.assert_array_equal(labels, labels_j)
    for a, b in zip(idx, idx_j):
        np.testing.assert_array_equal(a, b)
    return g, gj, labels, idx


# ---- the index system -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_split_arrays_equal_jax(seed, rate):
    g, _, labels, (idx_train, idx_val, idx_test) = _data()
    for got, want in zip(splits.idx_split(idx_test, rate, seed),
                         jax_splits.idx_split(idx_test, rate, seed)):
        np.testing.assert_array_equal(got, want)
    got = splits.graph_split(idx_train, idx_val, idx_test, rate, seed)
    want = jax_splits.graph_split(idx_train, idx_val, idx_test, rate, seed)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    obs_tr, obs_va, obs_te, idx_obs, idx_ind = got
    # obs node i is global node idx_obs[i]; the obs positions cover idx_obs
    np.testing.assert_array_equal(idx_obs[obs_tr], idx_train)
    np.testing.assert_array_equal(idx_obs[obs_va], idx_val)
    assert len(idx_ind) == int(len(idx_test) * rate)
    assert np.intersect1d(idx_obs, idx_ind).size == 0
    assert len(obs_tr) + len(obs_va) + len(obs_te) == len(idx_obs)


@pytest.mark.parametrize("which", ["idx_obs", "random"])
def test_subgraph_equal_jax(which, tier):
    g, gj, _, (idx_train, idx_val, idx_test) = _data()
    if which == "idx_obs":
        idx = splits.graph_split(idx_train, idx_val, idx_test, 0.2, 0)[3]
    else:
        idx = np.random.RandomState(3).permutation(g.n_nodes)[:200]
    sub, sub_j = g.subgraph(idx), gj.subgraph(idx)
    assert sub.n_nodes == sub_j.n_nodes == len(idx)
    np.testing.assert_array_equal(sub.src, sub_j.src)
    np.testing.assert_array_equal(sub.dst, sub_j.dst)
    assert sub.ndata.keys() == sub_j.ndata.keys()
    for k in sub.ndata:
        np.testing.assert_array_equal(sub.ndata[k], sub_j.ndata[k])
    # new id i is idx[i]: every kept edge maps back onto an edge of g, and
    # the synth graph's self-loops survive
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    assert all((idx[s], idx[d]) in edges for s, d in zip(sub.src, sub.dst))
    assert (sub.src == sub.dst).sum() == len(idx)


# ---- feature_prop and the min-cut loss ------------------------------------

def _graph_pair(g):
    return g.to_device("cpu"), jax_build_graph(g.src, g.dst, g.n_nodes)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_feature_prop_matches_jax(k):
    g, *_ = _data()
    gt, gj = _graph_pair(g)
    x = np.random.RandomState(k).randn(g.n_nodes, 32).astype(np.float32)
    got = graph_utils.feature_prop(torch.from_numpy(x), gt, k)
    want = jax_graph_utils.feature_prop(jnp.asarray(x), gj, k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_feature_prop_inductive_merge_matches_jax():
    """The CLIs' ind merge: the obs rows propagated on obs_g, the others on
    g (glnn_tpu/cli/train_teacher.py:213-218)."""
    g, _, _, (idx_train, idx_val, idx_test) = _data()
    idx_obs = splits.graph_split(idx_train, idx_val, idx_test, 0.2, 0)[3]
    obs = g.subgraph(idx_obs)
    x = np.asarray(g.ndata["feat"], np.float32)
    got = propagate_features(x, 2, g.to_device("cpu"),
                             obs.to_device("cpu"), idx_obs)
    want = np.array(jax_graph_utils.feature_prop(
        jnp.asarray(x), jax_build_graph(g.src, g.dst, g.n_nodes), 2))
    want[idx_obs] = np.asarray(jax_graph_utils.feature_prop(
        jnp.asarray(x[idx_obs]),
        jax_build_graph(obs.src, obs.dst, obs.n_nodes), 2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_f32_csr_sum_is_the_segment_sum():
    """spmm_csr_f32's plain version (and the wrapper on a CPU tensor) is
    refops.copy_u_sum in f32: no bf16 rounding of the messages."""
    g, *_ = _data()
    gt = g.to_device("cpu")
    x = torch.from_numpy(
        np.random.RandomState(0).randn(g.n_nodes, 128).astype(np.float32))
    want = refops.copy_u_sum(gt, x)
    for got in (refops.csr_sum_f32(gt.indptr, gt.senders, x, gt.n_nodes),
                spmm_cuda.csr_sum_f32(gt.indptr, gt.senders, x, gt.n_nodes)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    bf16 = spmm_cuda.csr_sum_bf16(gt.indptr, gt.senders,
                                  spmm_cuda.to_message(x), gt.n_nodes)
    assert (bf16 - want).abs().max().item() > 1e-3
    with pytest.raises(TypeError, match="float32"):
        spmm_cuda.csr_sum_f32(gt.indptr, gt.senders, x.double(), gt.n_nodes)


def test_min_cut_loss_matches_jax():
    g, *_ = _data()
    gt, gj = _graph_pair(g)
    logits = np.random.RandomState(5).randn(g.n_nodes, 5).astype(np.float32)
    out = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    got = graph_utils.compute_min_cut_loss(gt, torch.from_numpy(out))
    want = jax_graph_utils.compute_min_cut_loss(gj, jnp.asarray(out))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert 0.0 < float(got) <= 1.0


# ---- the inductive runners ------------------------------------------------

def _conf(name, **kw):
    conf = dict(model_name=name, num_layers=2, hidden_dim=16, feat_dim=32,
                label_dim=5, dropout_ratio=0.0, norm_type="none", seed=0,
                max_epoch=5, eval_interval=1, patience=50, batch_size=4096,
                learning_rate=0.01, weight_decay=5e-4)
    conf.update(kw)
    return conf


def _jax_init(conf, g, feats):
    """The initial variables JAX's runners draw: init_rng of
    split(PRNGKey(seed)), on the graph and features the runner passes."""
    jm = JaxModel(conf)
    init_rng = jax.random.split(jax.random.PRNGKey(conf["seed"]))[0]
    v = jax.tree_util.tree_map(np.asarray, jm.init(init_rng, g, feats))
    tm = Model(conf)
    from_jax_variables(v, tm)
    return jm, tm


@pytest.mark.parametrize("teacher", ["GCN", "MLP"])
def test_run_inductive_matches_jax(teacher):
    g, _, labels, (idx_train, idx_val, idx_test) = _data()
    indices = splits.graph_split(idx_train, idx_val, idx_test, 0.2, 0)
    idx_obs = indices[3]
    obs = g.subgraph(idx_obs)
    feats = np.asarray(g.ndata["feat"], np.float32)
    conf = _conf(teacher)
    gj = jax_build_graph(g.src, g.dst, g.n_nodes)
    obs_gj = jax_build_graph(obs.src, obs.dst, obs.n_nodes)
    jm, tm = _jax_init(conf, obs_gj, jnp.asarray(feats[idx_obs]))

    rows_j = []
    want = jax_run_inductive(conf, jm, gj, obs_gj, feats, labels, indices,
                             jax_make_adam(0.01, 5e-4), LOGGER, rows_j)
    gt, obs_gt = (None, None) if tm.is_mlp else (
        g.to_device("cpu"), obs.to_device("cpu"))
    rows, state_out = [], {}
    got = run_inductive(conf, tm, gt, obs_gt, feats, labels, indices,
                        make_adam(tm.parameters(), 0.01, 5e-4), LOGGER, rows,
                        torch.device("cpu"), state_out)

    assert got[0].shape == (g.n_nodes, 5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    assert len(rows) == len(rows_j) == 5
    assert all(len(r) == 9 for r in rows)
    np.testing.assert_allclose(np.array(rows), np.array(rows_j), rtol=1e-4,
                               atol=1e-5)

    # out[idx_obs] is the obs-graph eval, the other rows the full-graph eval
    # of the restored best model, whose state_dict state_out holds
    assert state_out["best_epoch"] == max(
        r[0] for r in rows if r[6] == max(r2[6] for r2 in rows))
    tm.load_state_dict(state_out["state_dict"])
    x = torch.from_numpy(feats)
    full = make_eval_fn(tm, exact=True)(gt, x)
    obs_out = (full[torch.from_numpy(idx_obs)] if tm.is_mlp
               else make_eval_fn(tm, exact=True)(obs_gt, x[idx_obs]))
    rest = np.setdiff1d(np.arange(g.n_nodes), idx_obs)
    np.testing.assert_array_equal(got[0][idx_obs], obs_out.numpy())
    np.testing.assert_array_equal(got[0][rest], full.numpy()[rest])
    if not tm.is_mlp:    # the obs graph's eval differs from the full one's
        assert np.abs(got[0][idx_obs] - full.numpy()[idx_obs]).max() > 1e-4


def test_distill_run_inductive_matches_jax():
    g, _, labels, (idx_train, idx_val, idx_test) = _data()
    obs_tr, obs_va, obs_te, idx_obs, idx_ind = splits.graph_split(
        idx_train, idx_val, idx_test, 0.2, 0)
    indices = (obs_tr, np.concatenate([obs_tr, obs_va, obs_te]), obs_va,
               obs_te, idx_obs, idx_ind)
    feats = np.asarray(g.ndata["feat"], np.float32)
    logits = np.random.RandomState(2).randn(g.n_nodes, 5).astype(np.float32)
    out_t = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    conf = _conf("MLP", lamb=0.3)
    jm, tm = _jax_init(conf, None, jnp.asarray(feats))

    rows_j = []
    want = jax_distill_ind(conf, jm, feats, labels, out_t, indices,
                           jax_make_adam(0.01, 5e-4), LOGGER, rows_j)
    rows, state_out = [], {}
    got = distill_run_inductive(conf, tm, feats, labels, out_t, indices,
                                make_adam(tm.parameters(), 0.01, 5e-4),
                                LOGGER, rows, torch.device("cpu"), state_out)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    assert len(rows) == 5 and all(len(r) == 9 for r in rows)
    np.testing.assert_allclose(np.array(rows), np.array(rows_j), rtol=1e-4,
                               atol=1e-5)
    assert set(state_out) == {"state_dict", "best_epoch"}
