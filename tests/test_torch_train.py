"""glnn_tpu_torch training pieces against glnn_tpu: one sampled-SAGE Adam
step, the losses, and the epoch/eval/runner contracts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu.sampling import sample_blocks as jax_sample_blocks
from glnn_tpu.train import losses as jax_losses
from glnn_tpu.train.losses import log_softmax as jax_log_softmax
from glnn_tpu.train.state import make_adam as jax_make_adam
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn import Model, from_jax_variables
from glnn_tpu_torch.sampling import sample_blocks
from glnn_tpu_torch.train import losses, make_adam
from glnn_tpu_torch.train.engine import (GRAPH_ROWS, _BestTracker,
                                         _module_state, eval_graph_counts,
                                         make_mlp_epoch_fn, make_mlp_eval_fn,
                                         row_bucket)
from glnn_tpu_torch.train.sage_sampled import sage_sampled_step

LR, WD = 0.01, 0.01


def _flat_params(tm):
    """Port parameters and BN statistics keyed by their flax path."""
    m = tm.module
    out = {}
    for i, conv in enumerate(m.convs):
        out[f"params/SAGEConvGCN_{i}/Dense_0/kernel"] = conv.fc.weight.T
        out[f"params/SAGEConvGCN_{i}/Dense_0/bias"] = conv.fc.bias
    for i, bn in enumerate(m.norms):
        out[f"params/BatchNorm1d_{i}/scale"] = bn.weight
        out[f"params/BatchNorm1d_{i}/bias"] = bn.bias
        out[f"batch_stats/BatchNorm1d_{i}/mean"] = bn.running_mean
        out[f"batch_stats/BatchNorm1d_{i}/var"] = bn.running_var
    return {k: v.detach().numpy() for k, v in out.items()}


def test_sampled_sage_step_matches_jax():
    n, f, fanouts = 150, 10, [3, 4]
    rs = np.random.RandomState(0)
    src, dst = rs.randint(0, n, 1800), rs.randint(0, n, 1800)
    gj, gt = jax_build_graph(src, dst, n), build_graph(src, dst, n)
    x = rs.randn(n, f).astype(np.float32)
    labels = rs.randint(0, 4, n)
    seeds = np.concatenate([rs.choice(n, 14, replace=False),
                            [n, n]]).astype(np.int32)
    conf = dict(model_name="SAGE", num_layers=2, hidden_dim=16, feat_dim=f,
                label_dim=4, dropout_ratio=0.0, norm_type="batch")

    rng = jax.random.PRNGKey(5)
    bj = jax_sample_blocks(gj, jnp.asarray(seeds), fanouts, rng)
    uniforms, c = [None, None], len(seeds)
    for i in (1, 0):
        uniforms[i] = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(rng, i), (c, fanouts[i]))))
        c *= fanouts[i] + 1
    bt = sample_blocks(gt, torch.from_numpy(seeds), fanouts, uniforms=uniforms)

    x_ext = np.concatenate([x, np.zeros((1, f), np.float32)])
    lab_ext = np.concatenate([labels, [0]])
    mask = (seeds < n).astype(np.float32)
    x_in = x_ext[np.asarray(bj.input_nodes)]
    y = lab_ext[seeds]

    jm = JaxModel(conf)
    v = jm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    opt = jax_make_adam(LR, WD)
    opt_state = opt.init(v["params"])

    def loss_fn(p):
        (_, h), upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               bj, jnp.asarray(x_in), training=True,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=True)
        logp = jax_log_softmax(h)
        per = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1)[:, 0]
        m = jnp.asarray(mask)
        return jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0), upd

    (loss_j, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    updates, _ = opt.update(grads, opt_state, v["params"])
    params_j = jax.tree_util.tree_map(lambda p, u: p + u, v["params"], updates)

    tm = Model(conf)
    from_jax_variables(jax.tree_util.tree_map(np.asarray, v), tm)
    topt = make_adam(tm.parameters(), LR, WD)
    loss_t = sage_sampled_step(tm, topt, bt, torch.from_numpy(x_in),
                               torch.from_numpy(y), torch.from_numpy(mask))

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = jax.tree_util.tree_map(
        np.asarray, {"params": params_j, "batch_stats": upd["batch_stats"]})
    for key, got in _flat_params(tm).items():
        node = want
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_allclose(got, node, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_losses_match_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(32, 7).astype(np.float32) * 3
    teacher = rs.randn(32, 7).astype(np.float32)
    labels = rs.randint(0, 7, 32)
    s_t = losses.log_softmax(torch.from_numpy(logits))
    t_t = losses.log_softmax(torch.from_numpy(teacher))
    s_j = jax_losses.log_softmax(jnp.asarray(logits))
    t_j = jax_losses.log_softmax(jnp.asarray(teacher))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(losses.nll_loss(s_t, torch.from_numpy(labels))),
        float(jax_losses.nll_loss(s_j, jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.kl_div_batchmean_log_target(s_t, t_t)),
        float(jax_losses.kl_div_batchmean_log_target(s_j, t_j)), rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.accuracy(s_t, torch.from_numpy(labels))),
        float(jax_losses.accuracy(s_j, jnp.asarray(labels))))


def _mlp(feat_dim=6, classes=3):
    conf = dict(model_name="MLP", num_layers=2, hidden_dim=8,
                feat_dim=feat_dim, label_dim=classes, dropout_ratio=0.1,
                norm_type="batch")
    return Model(conf, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("n,batch,steps", [(10, 4, 2), (3, 4, 1), (8, 4, 2)])
def test_mlp_epoch_drops_tail(n, batch, steps):
    model = _mlp()
    opt = make_adam(model.parameters(), 0.01, 0.0)
    sizes = []
    model.register_forward_hook(lambda m, args, out: sizes.append(
        args[1].shape[0]))
    epoch = make_mlp_epoch_fn(model, opt, batch, "nll")
    loss = epoch(torch.randn(n, 6), torch.randint(0, 3, (n,)),
                 torch.Generator().manual_seed(0))
    assert np.isfinite(loss)
    assert sizes == [min(batch, n)] * steps


def test_adam_advances_at_lamb_zero():
    model = _mlp()
    opt = make_adam(model.parameters(), 0.01, 0.0)
    before = [p.detach().clone() for p in model.parameters()]
    epoch = make_mlp_epoch_fn(model, opt, 4, "nll", lamb=0.0)
    epoch(torch.randn(8, 6), torch.randint(0, 3, (8,)),
          torch.Generator().manual_seed(0))
    assert all(opt.state[p]["step"] == 2 for p in model.parameters())
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_chunked_mlp_eval_equals_full():
    model = _mlp()
    x = torch.randn(37, 6)
    full = make_mlp_eval_fn(model)(x)
    chunked = make_mlp_eval_fn(model, 8)(x)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=1e-6)
    assert not model.training


def test_row_buckets_cover_every_chunk_size():
    """Every chunk size up to GRAPH_ROWS has a bucket at least as large,
    monotone in the size, 16 rows at the least and at most 19% above the
    size from 16 rows up; the serve traffic's 10-4,096 rows take 33."""
    sizes = np.arange(1, GRAPH_ROWS + 1)
    buckets = np.array([row_bucket(int(n)) for n in sizes])
    assert (buckets >= sizes).all()
    assert (np.diff(buckets) >= 0).all()
    assert (buckets[:16] == 16).all()
    assert (buckets[15:] <= 1.19 * sizes[15:]).all()
    assert buckets[-1] == GRAPH_ROWS
    assert len(set(buckets[9:4096].tolist())) == 33


def test_mlp_eval_on_cpu_runs_eagerly_and_keeps_no_graphs():
    """On the CPU the eval is today's eager forward, chunk by chunk, and
    its function captures nothing."""
    model = _mlp()
    x = torch.randn(37, 6)
    evaluate = make_mlp_eval_fn(model, 8)
    before = eval_graph_counts()
    got = evaluate(x)
    after = eval_graph_counts()
    assert after["eager"] == before["eager"] + 1
    assert (after["captures"], after["replays"]) == (before["captures"],
                                                     before["replays"])
    graphs = evaluate.graphs
    assert graphs.graphs == {} and graphs.rows == {} and graphs.key is None
    assert graphs.pool is None and graphs.stream is None
    with torch.no_grad():
        want = torch.cat([losses.log_softmax(model(None, x[i:i + 8])[1])
                          for i in range(0, 37, 8)])
    assert torch.equal(got, want)


def test_module_state_covers_every_parameter_buffer_and_mode():
    """The graph key's addresses are those of `parameters()` and
    `buffers()`, a replaced parameter changes them, and a module in
    training mode anywhere in the tree is seen."""
    model = _mlp()
    want = sorted(t.data_ptr() for t in [*model.parameters(),
                                         *model.buffers()])
    model.eval()
    ptrs, training = _module_state(model)
    assert sorted(ptrs) == want and not training
    model.module.norms[0].train()
    assert _module_state(model)[1]
    layer = model.module.layers[0]
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    assert sorted(_module_state(model)[0]) != want


def test_best_tracker_refreshes_on_ties():
    model = _mlp()
    tr = _BestTracker(model)
    tr.update(1, 0.5, model)
    with torch.no_grad():
        model.module.layers[0].bias.add_(1.0)
    tr.update(2, 0.5, model)            # tie: refresh, count reset
    assert tr.best_epoch == 2 and tr.count == 0
    assert torch.equal(tr.snap["module.layers.0.bias"],
                       model.module.layers[0].bias)
    tr.update(3, 0.4, model)
    assert tr.best_epoch == 2 and tr.count == 1
