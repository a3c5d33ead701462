"""glnn_tpu_torch's window sampler tier, dedup-mode blocks and bf16 compute
tier against glnn_tpu on the CPU.

* The sampler: the same seeds and JAX's own uniforms (drawn as
  `glnn_tpu.sampling.sample_blocks` draws them: fold_in(rng, hop) over the
  hop's frontier) through both samplers; every field of the blocks equal,
  bit for bit: the window tier with and without the aligned table, on a
  bounded-degree graph and on one with heavy, unaligned nodes (in-degrees
  70-300), and dedup mode with worst-case and with tight caps.
* `quantize_cols` bit-equal to `_quantize_cols` on bf16 and f32 input.
* bf16 forwards from JAX's initial weights: logits within 3e-2 x max|want|
  and argmax equal on at least 99% of rows (the bf16 products sum their
  f32 partials in another order, so an output can round to the
  neighbouring bf16 value); parameters f32; batch-norm running statistics
  at rtol 1e-3 (atol 1e-6).
* The sampled SAGE epoch and the MLP epoch in bf16 against JAX's in bf16:
  the epoch loss within 5% (the bound tests/test_sampling.py and
  tests/test_engine.py put on bf16 against f32; the two packages shuffle
  with their own streams); parameters, the Adam state and the loss f32.
* The CLIs with --sampler_tier window --compute_dtype bfloat16, tran and
  ind, and GCN, which ignores the compute dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu import ops as jax_ops
from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu.ops.spmm_pallas import _quantize_cols
from glnn_tpu.sampling import frontier_caps as jax_frontier_caps
from glnn_tpu.sampling import sample_blocks as jax_sample_blocks
from glnn_tpu.train.losses import log_softmax as jax_log_softmax
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.graph.host import HostGraph
from glnn_tpu_torch.nn import Model, from_jax_variables
from glnn_tpu_torch.ops.spmm_cuda import quantize_cols
from glnn_tpu_torch.sampling import (WINDOW1_EXACT_DEG, WINDOW_EXACT_DEG,
                                     frontier_caps, sample_blocks)
from glnn_tpu_torch.train import losses, make_adam
from glnn_tpu_torch.train.engine import make_mlp_epoch_fn
from glnn_tpu_torch.train.sage_sampled import make_sage_sampled_epoch_fn

HUBS = {17: 70, 101: 150, 202: 300}   # node -> extra in-edges (heavy graph)


def _edges(kind, seed=0):
    """(src, dst, n): "bounded" in-degrees <= 65, or "heavy" with the HUBS
    nodes at in-degrees 70-300 whose edges start off a 64-edge boundary."""
    rs = np.random.RandomState(seed)
    if kind == "bounded":
        n = 400
        return rs.randint(0, n, 3000), rs.randint(0, n, 3000), n
    n = 300
    src = [rs.randint(0, n, 1500)]
    dst = [rs.randint(0, n, 1500)]
    for hub, extra in HUBS.items():
        src.append(rs.randint(0, n, extra))
        dst.append(np.full(extra, hub))
    return np.concatenate(src), np.concatenate(dst), n


def _graphs(kind, table):
    src, dst, n = _edges(kind)
    gt, gj = build_graph(src, dst, n), jax_build_graph(src, dst, n)
    if table:
        gt, gj = gt.with_window_table(), gj.with_window_table()
    return gt, gj


def _seeds(n, b=24):
    """Every hub, a spread of other nodes and a ghost-padded tail."""
    s = (np.arange(b, dtype=np.int32) * 13) % n
    s[: len(HUBS)] = list(HUBS)
    s[-3:] = n
    return s


def _uniforms(rng, fanouts, sizes):
    """JAX's draws: hop i's uniforms from fold_in(rng, i) over a frontier
    of sizes[i] nodes."""
    return [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(rng, i), (sizes[i], f))))
        for i, f in enumerate(fanouts)]


def _concat_sizes(b, fanouts):
    sizes, c = [0] * len(fanouts), b
    for i in range(len(fanouts) - 1, -1, -1):
        sizes[i] = c
        c *= fanouts[i] + 1
    return sizes


def _dedup_sizes(b, caps):
    return [c + 1 for c in caps[1:-1]] + [b]


def _assert_same_blocks(bt, bj):
    np.testing.assert_array_equal(bt.input_nodes.numpy(),
                                  np.asarray(bj.input_nodes))
    assert bt.concat == bj.concat
    fields = ["valid", "out_real"]
    if bt.concat:
        # the port leaves concat mode's local ids implicit: JAX's must be
        # the static slices that SAGEConvGCN's concat branch reads
        assert bt.nbr_local == bt.self_local == ()
        for nl, sl, v in zip(bj.nbr_local, bj.self_local, bj.valid):
            n_out, k = v.shape
            np.testing.assert_array_equal(np.asarray(sl), np.arange(n_out))
            np.testing.assert_array_equal(
                np.asarray(nl), n_out + np.arange(n_out * k).reshape(n_out, k))
    else:
        fields += ["nbr_local", "self_local"]
    for field in fields:
        got, want = getattr(bt, field), getattr(bj, field)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)
    assert bool(bt.overflowed) == bool(bj.overflowed)


@pytest.mark.parametrize("fanouts", [[3, 5], [2, 4, 15]])
@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("kind", ["bounded", "heavy"])
def test_window_tier_bit_exact(kind, table, fanouts):
    gt, gj = _graphs(kind, table)
    deg = gt.in_degrees.numpy()
    if kind == "heavy":
        indptr = gt.indptr.numpy()
        assert min(deg[list(HUBS)]) >= 70 and max(deg[list(HUBS)]) >= 300
        assert all(indptr[h] % 64 for h in HUBS)
    else:
        assert deg.max() <= WINDOW_EXACT_DEG
    seeds = _seeds(gt.n_nodes)
    rng = jax.random.PRNGKey(3)
    bj = jax_sample_blocks(gj, jnp.asarray(seeds), fanouts, rng,
                           method="window")
    bt = sample_blocks(gt, torch.from_numpy(seeds), fanouts, method="window",
                       uniforms=_uniforms(rng, fanouts,
                                          _concat_sizes(len(seeds), fanouts)))
    _assert_same_blocks(bt, bj)


@pytest.mark.parametrize("table", [False, True])
def test_window_tier_folds_onto_own_edges(table):
    """A heavy node samples only its own first 64 in-edges (with the
    table) or its in-window edges (without: the two 64-wide rows holding
    its first edge)."""
    gt, _ = _graphs("heavy", table)
    indptr, senders = gt.indptr.numpy(), gt.senders.numpy()
    for hub in HUBS:
        start, deg = int(indptr[hub]), int(indptr[hub + 1] - indptr[hub])
        cap = 64 if table else min(deg, 128 - start % 64)
        allowed = set(senders[start:start + cap].tolist())
        seeds = torch.full((200,), hub, dtype=torch.int32)
        b = sample_blocks(gt, seeds, [7], torch.Generator().manual_seed(hub),
                          method="window")
        got = set(b.input_nodes[200:].tolist())
        assert got <= allowed and len(got) > 7


def test_window_tier_equals_floyd_below_exact_degree():
    gt, _ = _graphs("bounded", False)
    assert gt.in_degrees.max() <= min(WINDOW_EXACT_DEG, WINDOW1_EXACT_DEG)
    seeds = torch.from_numpy(_seeds(gt.n_nodes))
    want = sample_blocks(gt, seeds, [5, 10], torch.Generator().manual_seed(7))
    for g in (gt, gt.with_window_table()):
        got = sample_blocks(g, seeds, [5, 10],
                            torch.Generator().manual_seed(7), method="window")
        assert torch.equal(got.input_nodes, want.input_nodes)


@pytest.mark.parametrize("caps", ["worst", "tight"])
@pytest.mark.parametrize("tier", [("floyd", "bounded", False),
                                  ("window", "heavy", True),
                                  ("window", "heavy", False)])
def test_dedup_blocks_bit_exact(tier, caps):
    method, kind, table = tier
    gt, gj = _graphs(kind, table)
    seeds = _seeds(gt.n_nodes)
    fanouts = [3, 5]
    cap_list = frontier_caps(len(seeds), fanouts, gt.n_nodes)
    assert cap_list == jax_frontier_caps(len(seeds), fanouts, gt.n_nodes)
    if caps == "tight":
        cap_list = [40, 30, len(seeds)]
    rng = jax.random.PRNGKey(11)
    bj = jax_sample_blocks(gj, jnp.asarray(seeds), fanouts, rng,
                           caps=cap_list, method=method)
    bt = sample_blocks(gt, torch.from_numpy(seeds), fanouts, method=method,
                       caps=cap_list,
                       uniforms=_uniforms(rng, fanouts,
                                          _dedup_sizes(len(seeds), cap_list)))
    _assert_same_blocks(bt, bj)
    assert not bt.concat
    assert bool(bt.overflowed) == (caps == "tight")
    assert bt.input_nodes.shape == (cap_list[0] + 1,)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_cols_bit_equal_to_jax(dtype):
    rs = np.random.RandomState(2)
    x = (rs.randn(257, 40) * rs.uniform(1e-3, 1e3, 40)).astype(np.float32)
    x[:, 5] = 0.0                                 # an all-zero column
    q, s = quantize_cols(torch.from_numpy(x).to(getattr(torch, dtype)))
    qj, sj = _quantize_cols(jnp.asarray(x).astype(dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


# -- bf16 forwards from JAX's initial weights ------------------------------

N, F_IN, HIDDEN, CLASSES = 300, 12, 32, 5


def _conf(name, norm, dtype="bfloat16"):
    return dict(model_name=name, num_layers=3, hidden_dim=HIDDEN,
                feat_dim=F_IN, label_dim=CLASSES, dropout_ratio=0.0,
                norm_type=norm, compute_dtype=dtype)


def _pair(name, norm, gj, x):
    """The JAX bf16 model, its initial variables (random running
    statistics) and the port's bf16 model holding them."""
    rs = np.random.RandomState(5)
    jm = JaxModel(_conf(name, norm))
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), gj, jnp.asarray(x)))
    for st in v.get("batch_stats", {}).values():
        st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32) * 0.3
        st["var"] = rs.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    tm = Model(_conf(name, norm))
    from_jax_variables(v, tm)
    return jm, v, tm


def _close_logits(got, want):
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.99


def _assert_f32(model):
    for name, t in model.state_dict().items():
        assert not t.is_floating_point() or t.dtype == torch.float32, name


def _assert_stats(tm, stats):
    for i, bn in enumerate(tm.module.norms):
        want = stats[f"BatchNorm1d_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), want["var"],
                                   rtol=1e-3, atol=1e-6)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, N, 2400), rs.randint(0, N, 2400)
    x = rs.randn(N, F_IN).astype(np.float32)
    return build_graph(src, dst, N), jax_build_graph(src, dst, N), x


@pytest.fixture(autouse=True)
def _backends():
    yield
    jax_ops.set_backend("auto")
    ops.set_backend("auto")


@pytest.mark.parametrize("norm", ["batch", "layer", "none"])
def test_bf16_mlp_forward_matches_jax(norm):
    _, gj, x = _data()
    jm, v, tm = _pair("MLP", norm, gj, x)
    tm.eval()
    want = jm.apply(v, None, jnp.asarray(x), training=False)[1]
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = tm(None, torch.from_numpy(x))[1]
    _close_logits(got, want)
    _assert_f32(tm)
    if norm == "batch":                  # training mode: the batch stats
        tm.train()
        (_, want), upd = jm.apply(v, None, jnp.asarray(x), training=True,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        with torch.no_grad():
            got = tm(None, torch.from_numpy(x))[1]
        _close_logits(got, want)
        _assert_stats(tm, jax.tree_util.tree_map(np.asarray,
                                                 upd["batch_stats"]))


@pytest.mark.parametrize("norm", ["batch", "layer"])
def test_bf16_sage_full_graph_matches_jax(norm):
    gt, gj, x = _data()
    jm, v, tm = _pair("SAGE", norm, gj, x)
    jax_ops.set_backend("xla")
    tm.eval()
    want = jm.apply(v, gj, jnp.asarray(x), training=False)[1]
    with torch.no_grad():
        got = tm(gt, torch.from_numpy(x))[1]
    _close_logits(got, want)
    _assert_f32(tm)


@pytest.mark.parametrize("norm", ["batch", "layer"])
@pytest.mark.parametrize("mode", ["concat", "dedup"])
def test_bf16_sage_blocks_match_jax(mode, norm):
    """A training-mode forward over concat or dedup blocks (the dedup
    branch gathers through nbr_local / self_local), batch statistics
    masked to the real output rows."""
    gt, gj, x = _data(1)
    jm, v, tm = _pair("SAGE", norm, gj, x)
    seeds = np.concatenate([np.arange(0, N, 7)[:30], [N, N]]).astype(np.int32)
    fanouts = [4, 3, 5]
    rng = jax.random.PRNGKey(2)
    caps = (frontier_caps(len(seeds), fanouts, N) if mode == "dedup"
            else None)
    sizes = (_dedup_sizes(len(seeds), caps) if caps
             else _concat_sizes(len(seeds), fanouts))
    bj = jax_sample_blocks(gj, jnp.asarray(seeds), fanouts, rng, caps=caps)
    bt = sample_blocks(gt, torch.from_numpy(seeds), fanouts, caps=caps,
                       uniforms=_uniforms(rng, fanouts, sizes))
    _assert_same_blocks(bt, bj)
    x_in = np.concatenate([x, np.zeros((1, F_IN), np.float32)])[
        np.asarray(bj.input_nodes)]
    (_, want), upd = jm.apply(v, bj, jnp.asarray(x_in), training=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
    tm.train()
    with torch.no_grad():
        got = tm(bt, torch.from_numpy(x_in))[1]
    real = seeds < N
    _close_logits(got[torch.from_numpy(real)], np.asarray(want)[real])
    _assert_f32(tm)
    if norm == "batch":
        _assert_stats(tm, jax.tree_util.tree_map(np.asarray,
                                                 upd["batch_stats"]))


@pytest.mark.parametrize("norm", ["batch", "layer"])
def test_norms_under_bf16_input_match_jax(norm):
    """Batch norm (masked, training): f32 statistics, bf16 out, running
    statistics at rtol 1e-3; layer norm: computed in bf16, its f32 scale
    promotes the output to f32 in both packages."""
    from glnn_tpu.nn.layers import BatchNorm1d as JaxBN
    from glnn_tpu.nn.layers import LayerNorm1d as JaxLN
    from glnn_tpu_torch.nn.layers import BatchNorm1d, LayerNorm1d

    rs = np.random.RandomState(8)
    x = (rs.randn(200, 24) * 3 + 1).astype(np.float32)
    mask = rs.rand(200) < 0.8
    scale = rs.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rs.randn(24).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if norm == "batch":
        mod = JaxBN(use_running_average=False)
        v = mod.init(jax.random.PRNGKey(0), xb, jnp.asarray(mask))
        v = {"params": {"scale": scale, "bias": bias},
             "batch_stats": v["batch_stats"]}
        want, upd = mod.apply(v, xb, jnp.asarray(mask),
                              mutable=["batch_stats"])
        tn = BatchNorm1d(24).train()
    else:
        want = JaxLN().apply({"params": {"scale": scale, "bias": bias}}, xb)
        tn = LayerNorm1d(24)
    with torch.no_grad():
        tn.weight.copy_(torch.from_numpy(scale))
        tn.bias.copy_(torch.from_numpy(bias))
        got = tn(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= (
        2.0 ** -7 * np.abs(want).max())
    if norm == "batch":
        stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
        np.testing.assert_allclose(tn.running_mean.numpy(), stats["mean"],
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(tn.running_var.numpy(), stats["var"],
                                   rtol=1e-3, atol=1e-6)
        assert tn.running_mean.dtype == torch.float32


@pytest.mark.parametrize("name", ["MLP", "SAGE"])
def test_bf16_parameter_tree_matches_f32(name):
    """A bf16 model's JAX variables have the f32 model's paths, shapes and
    dtypes (flax keeps param_dtype f32), so from_jax_variables takes
    either unchanged."""
    _, gj, x = _data()
    trees = {dt: jax.tree_util.tree_map(
        lambda a: (a.shape, a.dtype),
        JaxModel(_conf(name, "batch", dt)).init(jax.random.PRNGKey(1), gj,
                                                jnp.asarray(x)))
        for dt in ("float32", "bfloat16")}
    assert trees["float32"] == trees["bfloat16"]
    _assert_f32(_pair(name, "batch", gj, x)[2])


def test_log_softmax_of_bf16_logits_is_f32():
    rs = np.random.RandomState(4)
    logits = (rs.randn(64, 7) * 4).astype(np.float32)
    got = losses.log_softmax(torch.from_numpy(logits).bfloat16())
    want = jax_log_softmax(jnp.asarray(logits).astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -- bf16 epochs against JAX's ----------------------------------------------

def _assert_adam_f32(opt):
    for state in opt.state.values():
        for t in state.values():
            assert not t.is_floating_point() or t.dtype == torch.float32


@pytest.mark.parametrize("tier", ["window", "floyd"])
def test_bf16_sampled_epoch_close_to_jax(tier):
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_make_adam
    from glnn_tpu.train.sage_sampled import \
        make_sage_sampled_epoch_fn as jax_epoch_fn

    rs = np.random.RandomState(13)
    n, e, f = 600, 6000, 32
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    gj = jax_build_graph(src, dst, n).with_window_table()
    gt = build_graph(src, dst, n).with_window_table()
    x = rs.randn(n, f).astype(np.float32)
    labels = rs.randint(0, 5, n)
    itr = np.arange(400)
    conf = dict(model_name="SAGE", num_layers=2, hidden_dim=64, feat_dim=f,
                label_dim=5, dropout_ratio=0.0, norm_type="batch",
                compute_dtype="bfloat16")
    jm = JaxModel(conf)
    v = jm.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    opt = jax_make_adam(0.01, 0.0)
    st = create_train_state(v, opt)
    _, loss_j, _ = jax_epoch_fn(jm, opt, 64, (3, 5), sampler_tier=tier)(
        st, gj, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(itr),
        jax.random.PRNGKey(1))

    tm = Model(conf)
    from_jax_variables(jax.tree_util.tree_map(np.asarray, v), tm)
    topt = make_adam(tm.parameters(), 0.01, 0.0)
    gathered = []
    tm.register_forward_pre_hook(lambda m, args: gathered.append(
        args[1].dtype))
    loss_t, overflow = make_sage_sampled_epoch_fn(
        tm, topt, 64, (3, 5), sampler_tier=tier)(
        gt, torch.from_numpy(x), torch.from_numpy(labels),
        torch.from_numpy(itr), torch.Generator().manual_seed(1))
    assert isinstance(loss_t, float) and not overflow
    assert gathered == [torch.bfloat16] * 7     # 400 / 64 batches
    assert abs(loss_t - float(loss_j)) < 0.05 * abs(float(loss_j))
    _assert_f32(tm)
    _assert_adam_f32(topt)


def test_bf16_mlp_epoch_close_to_jax():
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_make_adam
    from glnn_tpu.train import make_mlp_epoch_fn as jax_epoch_fn

    rs = np.random.RandomState(21)
    x = rs.randn(600, 24).astype(np.float32)
    labels = rs.randint(0, 5, 600)
    conf = dict(model_name="MLP", num_layers=2, hidden_dim=64, feat_dim=24,
                label_dim=5, dropout_ratio=0.0, norm_type="none",
                compute_dtype="bfloat16")
    jm = JaxModel(conf)
    v = jm.init(jax.random.PRNGKey(0), None, jnp.asarray(x[:2]))
    opt = jax_make_adam(0.01, 0.0)
    _, loss_j = jax_epoch_fn(jm, opt, batch_size=64, criterion="nll")(
        create_train_state(v, opt), jnp.asarray(x), jnp.asarray(labels),
        jax.random.PRNGKey(1))
    tm = Model(conf)
    from_jax_variables(jax.tree_util.tree_map(np.asarray, v), tm)
    topt = make_adam(tm.parameters(), 0.01, 0.0)
    loss_t = make_mlp_epoch_fn(tm, topt, 64, "nll")(
        torch.from_numpy(x), torch.from_numpy(labels),
        torch.Generator().manual_seed(1))
    assert abs(loss_t - float(loss_j)) < 0.05 * abs(float(loss_j))
    _assert_f32(tm)
    _assert_adam_f32(topt)


# -- the CLIs ------------------------------------------------------------------

DATASET = "synth-n512-c5-f32-d8-noise3.0"


def _args(*extra):
    return ["--device", "-1", "--dataset", DATASET, "--max_epoch", "3",
            "--patience", "10", *extra]


def test_host_graph_marks_window_table():
    rs = np.random.RandomState(0)
    host = HostGraph(rs.randint(0, 50, 300), rs.randint(0, 50, 300), 50)
    assert host.to_device("cpu").win1 is False
    g = host.to_device("cpu", window_table=True)
    assert g.win1 is True and g.to("cpu").win1 is True


@pytest.mark.parametrize("setting", ["tran", "ind"])
def test_cli_window_bf16_teacher_then_student(tmp_path, monkeypatch, capsys,
                                              setting):
    """SAGE on the window tier in bf16 (the table on the full and on the
    observed graph), then a bf16 MLP student: finite f32 out.npz, one score
    (two in ind), f32 checkpoints."""
    from glnn_tpu_torch.cli import train_student, train_teacher
    from glnn_tpu_torch.train import sage_sampled
    from glnn_tpu_torch.utils import load_model

    monkeypatch.chdir(tmp_path)
    seen = []
    real = sage_sampled.sample_blocks

    def spy(g, *args, **kw):
        seen.append((g.n_nodes, g.win1, kw.get("method")))
        return real(g, *args, **kw)

    monkeypatch.setattr(sage_sampled, "sample_blocks", spy)
    flags = ["--sampler_tier", "window", "--compute_dtype", "bfloat16",
             "--exp_setting", setting, "--save_results"]
    train_teacher.main(_args("--teacher", "SAGE", *flags))
    train_student.main(_args("--teacher", "SAGE", "--student", "MLP", *flags))
    # every batch on the window tier of a graph with the table: the full
    # graph in tran, the observed graph (fewer nodes) in ind
    assert seen and {s[1:] for s in seen} == {(True, "window")}
    assert {s[0] for s in seen} == ({512} if setting == "tran"
                                    else {min(s[0] for s in seen)})
    assert setting == "tran" or seen[0][0] < 512
    sub = ("transductive" if setting == "tran"
           else "inductive/split_rate_0.2")
    for model in ("SAGE", "SAGE_MLP"):
        run = tmp_path / "outputs" / sub / DATASET / model / "seed_0"
        out = np.load(run / "out.npz")["arr_0"]
        assert out.dtype == np.float32 and out.shape == (512, 5)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(np.exp(out).sum(1), 1.0, rtol=1e-4)
        state = load_model(run / "model.ckpt")
        assert all(t.dtype == torch.float32 for t in state.values()
                   if t.is_floating_point())
    lines = [l for l in capsys.readouterr().out.split("\n") if l.strip()]
    assert len(lines) == 2
    for line in lines:
        scores = [float(s) for s in line.split()]
        assert len(scores) == (1 if setting == "tran" else 2)
        assert all(np.isfinite(scores))


def test_cli_gcn_ignores_compute_dtype(tmp_path, monkeypatch):
    from glnn_tpu_torch.cli import train_teacher

    outs = []
    for i, extra in enumerate(([], ["--compute_dtype", "bfloat16"])):
        monkeypatch.chdir(tmp_path)
        train_teacher.main(_args("--teacher", "GCN", "--output_path",
                                 f"out{i}", *extra))
        outs.append(np.load(tmp_path / f"out{i}" / "transductive" / DATASET
                            / "GCN" / "seed_0" / "out.npz")["arr_0"])
    np.testing.assert_array_equal(outs[0], outs[1])
