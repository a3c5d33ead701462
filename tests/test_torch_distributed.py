"""The port's sharded paths on 4 gloo ranks (CPU) against `glnn_tpu` on a
4-device mesh of the conftest's 8 virtual devices, from the same numpy
inputs and JAX's initial weights: `halo_copy_u_sum` forward and gradient,
one halo GCN training step (no norm and batch norm), `fetch_rows`, the
take-all data-parallel sampled SAGE epoch (no norm and batch norm), and the
data-parallel MLP epoch (also against the port's own single-process epoch,
with dropout).

All port-side cases run in one launch of 4 ranks (`_rank_cases`), shared
by the tests through a module fixture. JAX is imported only inside the
fixtures and tests, so that the ranks, which import this module, never
load it."""

import sys

import numpy as np
import pytest
import torch

from glnn_tpu_torch.distributed import mesh, runners
from glnn_tpu_torch.distributed.halo import (
    build_halo_graph,
    halo_copy_u_sum,
    shard_rows,
)
from glnn_tpu_torch.distributed.sampling import (
    fetch_rows,
    make_dp_sampled_sage_epoch_fn,
)
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn.convert import from_jax_variables
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.train import make_adam

P = 4
LR, WD = 0.01, 0.0005


def _graph(n, e, f, seed):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    return src, dst, rs.randn(n, f).astype(np.float32), rs


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _port_model(conf, variables):
    model = Model(conf)
    from_jax_variables(variables, model)
    return model


# ---------------------------------------------------------------------------
# the inputs (numpy, seeded) and the port's side, run on every rank
# ---------------------------------------------------------------------------

SPMM = dict(n=203, e=1500, f=16, seed=1)
GCN = dict(n=264, e=2000, f=24, seed=5)
FETCH = dict(n=203, f=12, c=37, seed=3)
SAGE = dict(n=257, e=900, f=16, seed=11, batch=64)
MLP = dict(n=512, f=16, c=5, seed=10, batch=64)


def _gcn_conf(norm):
    return dict(model_name="GCN", num_layers=2, hidden_dim=32, feat_dim=24,
                label_dim=5, dropout_ratio=0.0, norm_type=norm)


def _sage_conf(norm):
    return dict(model_name="SAGE", num_layers=2, hidden_dim=32, feat_dim=16,
                label_dim=5, dropout_ratio=0.0, norm_type=norm)


def _mlp_conf(norm, dropout):
    return dict(model_name="MLP", num_layers=3, hidden_dim=32, feat_dim=16,
                label_dim=5, dropout_ratio=dropout, norm_type=norm)


def _rank_cases(m, pl):
    """Every port-side case on this rank; rank 0 returns the results."""
    r = m.rank
    res = {"jax_loaded": any(k.split(".")[0] in ("jax", "jaxlib", "glnn_tpu")
                             for k in sys.modules)}

    # halo_copy_u_sum: f32 plain tier forward and gradient, and the exact
    # kernel tier (its plain version on the CPU)
    hg = pl["spmm_hg"]
    x = torch.from_numpy(shard_rows(pl["spmm_x"], P, r)).requires_grad_()
    co = torch.from_numpy(shard_rows(pl["spmm_co"], P, r))
    out = halo_copy_u_sum(hg, x, kernel=False)
    (out * co).sum().backward()
    res["spmm_out"] = mesh.all_gather_rows(out.detach()).numpy()
    res["spmm_grad"] = mesh.all_gather_rows(x.grad).numpy()
    res["spmm_kernel_tier"] = mesh.all_gather_rows(
        halo_copy_u_sum(hg, x.detach(), kernel=True)).numpy()

    # one halo GCN step
    for norm in ("none", "batch"):
        model = _port_model(_gcn_conf(norm), pl[f"gcn_vars_{norm}"])
        runners._sync_batch_norm(model, True)
        opt = make_adam(model.parameters(), LR, WD)
        step = runners.make_halo_train_step(model, opt)
        loss = step(pl["gcn_hg"], torch.from_numpy(
            shard_rows(pl["gcn_x"], P, r)), torch.from_numpy(pl["gcn_labels"]),
            torch.from_numpy(pl["gcn_idx"]), torch.Generator())
        res[f"gcn_{norm}"] = (loss, _state(model))

    # fetch_rows
    got = fetch_rows(torch.from_numpy(shard_rows(pl["fetch_x"], P, r)),
                     torch.from_numpy(pl["fetch_idx"][r]),
                     -(-FETCH["n"] // P), FETCH["n"])
    res["fetch"] = mesh.all_gather_rows(got).numpy()

    # the take-all data-parallel sampled SAGE epoch
    g = build_graph(pl["sage_src"], pl["sage_dst"], SAGE["n"])
    for norm in ("none", "batch"):
        model = _port_model(_sage_conf(norm), pl[f"sage_vars_{norm}"])
        opt = make_adam(model.parameters(), LR, 0.0)
        epoch = make_dp_sampled_sage_epoch_fn(model, opt, SAGE["batch"],
                                              pl["sage_fanouts"])
        loss, ovf = epoch(g, torch.from_numpy(shard_rows(pl["sage_x"], P, r)),
                          torch.from_numpy(pl["sage_labels"]),
                          torch.from_numpy(pl["sage_idx"]), torch.Generator(),
                          torch.Generator().manual_seed(r),
                          perm=torch.from_numpy(pl["sage_perm"]))
        res[f"sage_{norm}"] = (loss, ovf, _state(model))

    # the data-parallel MLP epoch: JAX's shuffle without dropout (nll and
    # kl), and the port's own shuffle and masks with dropout
    block = torch.from_numpy(shard_rows(np.concatenate(
        [pl["mlp_x"], pl["mlp_t"]], 1), P, r))
    ids = torch.arange(MLP["n"])
    labels = torch.from_numpy(pl["mlp_labels"])
    for crit in ("nll", "kl"):
        model = _port_model(_mlp_conf("batch", 0.0), pl["mlp_vars"])
        runners._sync_batch_norm(model, True)
        opt = make_adam(model.parameters(), LR, 0.0)
        epoch = runners.make_dp_mlp_epoch_fn(model, opt, MLP["batch"], crit)
        loss = epoch(block, ids, labels, MLP["f"], torch.Generator(),
                     perm=torch.from_numpy(pl["mlp_perm"]))
        res[f"mlp_{crit}"] = (loss, _state(model))
    model = _port_model(_mlp_conf("batch", 0.5), pl["mlp_vars"])
    runners._sync_batch_norm(model, True)
    opt = make_adam(model.parameters(), LR, 0.0)
    epoch = runners.make_dp_mlp_epoch_fn(model, opt, MLP["batch"], "nll")
    loss = epoch(block, ids, labels, MLP["f"], torch.Generator().manual_seed(7))
    res["mlp_dropout"] = (loss, _state(model))
    return res if r == 0 else None


@pytest.fixture(scope="module")
def jax4():
    import jax

    from glnn_tpu.distributed.mesh import make_mesh

    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    return make_mesh(P, axis="graph")


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs, and JAX's initial weights where a model runs."""
    import jax
    import jax.numpy as jnp

    from glnn_tpu.graph.container import build_graph as jax_build_graph
    from glnn_tpu.nn.models import Model as JaxModel

    def np_tree(v):
        return jax.tree_util.tree_map(np.asarray, v)

    pl = {}
    src, dst, x, rs = _graph(SPMM["n"], SPMM["e"], SPMM["f"], SPMM["seed"])
    rows = -(-SPMM["n"] // P)
    pl.update(spmm_src=src, spmm_dst=dst, spmm_x=x,
              spmm_co=np.random.RandomState(2).randn(
                  rows * P, SPMM["f"]).astype(np.float32))

    src, dst, x, rs = _graph(GCN["n"], GCN["e"], GCN["f"], GCN["seed"])
    rs = np.random.RandomState(6)
    pl.update(gcn_src=src, gcn_dst=dst, gcn_x=x,
              gcn_labels=rs.randint(0, 5, GCN["n"]),
              gcn_idx=rs.choice(GCN["n"], 50, replace=False))
    gj = jax_build_graph(src, dst, GCN["n"])
    for norm in ("none", "batch"):
        pl[f"gcn_vars_{norm}"] = np_tree(JaxModel(_gcn_conf(norm)).init(
            jax.random.PRNGKey(0), gj, jnp.asarray(x)))

    rs = np.random.RandomState(FETCH["seed"])
    pl["fetch_x"] = rs.randn(FETCH["n"], FETCH["f"]).astype(np.float32)
    pl["fetch_idx"] = rs.randint(0, FETCH["n"] + 2, (P, FETCH["c"]))

    rs = np.random.RandomState(SAGE["seed"])
    src, dst = rs.randint(0, SAGE["n"], SAGE["e"]), rs.randint(0, SAGE["n"],
                                                               SAGE["e"])
    max_deg = int(np.bincount(dst, minlength=SAGE["n"]).max())
    pl.update(sage_src=src, sage_dst=dst,
              sage_x=rs.randn(SAGE["n"], SAGE["f"]).astype(np.float32),
              sage_labels=rs.randint(0, 5, SAGE["n"]),
              sage_fanouts=(max_deg, max_deg))
    pl["sage_idx"] = np.sort(rs.choice(SAGE["n"], 150, replace=False))
    perm_rng = jax.random.split(jax.random.PRNGKey(7), 3)[0]
    pl["sage_perm"] = np.asarray(jax.random.permutation(perm_rng, 150))
    gj = jax_build_graph(src, dst, SAGE["n"])
    for norm in ("none", "batch"):
        pl[f"sage_vars_{norm}"] = np_tree(JaxModel(_sage_conf(norm)).init(
            jax.random.PRNGKey(0), gj, jnp.asarray(pl["sage_x"])))

    rs = np.random.RandomState(MLP["seed"])
    pl["mlp_x"] = rs.randn(MLP["n"], MLP["f"]).astype(np.float32)
    pl["mlp_labels"] = rs.randint(0, MLP["c"], MLP["n"])
    t = rs.randn(MLP["n"], MLP["c"]).astype(np.float32)
    pl["mlp_t"] = (t - np.log(np.exp(t).sum(1, keepdims=True))).astype(
        np.float32)
    pl["mlp_vars"] = np_tree(JaxModel(_mlp_conf("batch", 0.0)).init(
        jax.random.PRNGKey(0), None, jnp.asarray(pl["mlp_x"][:2])))
    perm_rng = jax.random.split(jax.random.PRNGKey(3))[0]
    pl["mlp_perm"] = np.asarray(jax.random.permutation(perm_rng, MLP["n"]))
    return pl


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results of `_rank_cases` on 4 gloo ranks."""
    spmm = build_halo_graph(inputs["spmm_src"], inputs["spmm_dst"], SPMM["n"],
                            P)
    gcn = build_halo_graph(inputs["gcn_src"], inputs["gcn_dst"], GCN["n"], P)
    payloads = [dict(inputs, spmm_hg=spmm[r], gcn_hg=gcn[r]) for r in range(P)]
    return mesh.launch(_rank_cases, payloads, -1, timeout=240)


# Under batch norm the gradient of a bias that feeds the norm is zero up to
# rounding, and Adam scales such a gradient to steps of up to the learning
# rate whose sign rounding decides; the running means carry that bias.
# Nothing else depends on it (the norm removes the shift): those entries
# are held within the learning rate per step, every other one at the
# stated tolerance.
_SHIFTED = ("module.convs.0.fc.bias", "module.convs.0.bias",
            "module.layers.0.bias", "module.layers.1.bias", "running_mean")


def _assert_state(got: dict, conf, variables, rtol, atol, steps=1):
    _assert_close(got, _state(_port_model(conf, variables)), conf, rtol, atol,
                  steps)


def _assert_close(got: dict, want: dict, conf, rtol, atol, steps):
    assert got.keys() == want.keys()
    for k in want:
        shifted = conf["norm_type"] == "batch" and k.endswith(_SHIFTED)
        np.testing.assert_allclose(
            got[k], want[k], rtol=0 if shifted else rtol,
            atol=steps * LR if shifted else atol, err_msg=k)


def test_ranks_never_load_jax(port):
    assert not port["jax_loaded"]


def test_halo_copy_u_sum_forward_and_gradient(port, inputs, jax4):
    import jax
    import jax.numpy as jnp

    from glnn_tpu.distributed.halo import build_halo_graph as jax_halo
    from glnn_tpu.distributed.halo import halo_copy_u_sum as jax_sum
    from glnn_tpu.distributed.halo import shard_features

    hg = jax_halo(inputs["spmm_src"], inputs["spmm_dst"], SPMM["n"], jax4)
    xs = shard_features(inputs["spmm_x"], hg)
    co = jnp.asarray(inputs["spmm_co"])
    out = np.asarray(jax.jit(lambda a: jax_sum(hg, a))(xs))
    grad = np.asarray(jax.jit(jax.grad(
        lambda a: (jax_sum(hg, a) * co).sum()))(xs))
    np.testing.assert_allclose(port["spmm_out"], out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["spmm_grad"], grad, rtol=1e-5, atol=1e-5)
    assert np.abs(port["spmm_out"][SPMM["n"]:]).max() == 0.0


def test_halo_copy_u_sum_kernel_tier_matches_single_device(port, inputs):
    """The kernel tier's halo sum (its plain version here) equals the
    single-device exact tier: the same bf16 messages summed in f32."""
    from glnn_tpu_torch.ops import spmm_cuda

    g = build_graph(inputs["spmm_src"], inputs["spmm_dst"], SPMM["n"])
    want = spmm_cuda.copy_u_sum(g, torch.from_numpy(inputs["spmm_x"])).numpy()
    np.testing.assert_allclose(port["spmm_kernel_tier"][:SPMM["n"]], want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["none", "batch"])
def test_halo_gcn_step_matches_jax(port, inputs, jax4, norm):
    import jax
    import jax.numpy as jnp

    from glnn_tpu.distributed.halo import build_halo_graph as jax_halo
    from glnn_tpu.distributed.halo import shard_features
    from glnn_tpu.nn.models import Model as JaxModel
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_adam
    from glnn_tpu.train import make_gnn_train_step

    hg = jax_halo(inputs["gcn_src"], inputs["gcn_dst"], GCN["n"], jax4)
    labels = np.concatenate([inputs["gcn_labels"],
                             np.zeros(hg.n_pad - GCN["n"], np.int64)])
    opt = jax_adam(LR, WD)
    step = make_gnn_train_step(JaxModel(_gcn_conf(norm)), opt)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       inputs[f"gcn_vars_{norm}"])
    s1, loss = step(create_train_state(variables, opt), hg,
                    shard_features(inputs["gcn_x"], hg), jnp.asarray(labels),
                    jnp.asarray(inputs["gcn_idx"]), jax.random.PRNGKey(1))
    got_loss, got = port[f"gcn_{norm}"]
    assert abs(got_loss - float(loss)) < 1e-5
    _assert_state(got, _gcn_conf(norm), jax.tree_util.tree_map(
        np.asarray, {"params": s1.params, "batch_stats": s1.batch_stats}),
        rtol=1e-4, atol=1e-5)


def test_fetch_rows_matches_local_gather(port, inputs):
    x_pad = np.concatenate([inputs["fetch_x"],
                            np.zeros((2, FETCH["f"]), np.float32)])
    want = x_pad[np.minimum(inputs["fetch_idx"], FETCH["n"])]
    np.testing.assert_array_equal(port["fetch"].reshape(want.shape), want)


@pytest.mark.parametrize("norm", ["none", "batch"])
def test_dp_sampled_sage_epoch_takeall_matches_jax(port, inputs, jax4, norm):
    """Take-all fanouts and no dropout: JAX's data-parallel epoch on 4
    devices from the same shuffle; without batch norm also its
    single-device epoch (per-rank batch statistics differ from it)."""
    import jax
    import jax.numpy as jnp

    from glnn_tpu.distributed.sampling import (
        make_dp_sampled_sage_epoch_fn as jax_dp_epoch,
        shard_rows as jax_shard_rows)
    from glnn_tpu.graph.container import build_graph as jax_build_graph
    from glnn_tpu.nn.models import Model as JaxModel
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_adam
    from glnn_tpu.train.sage_sampled import make_sage_sampled_epoch_fn

    dmesh = jax.sharding.Mesh(jax4.devices, ("dp",))
    gj = jax_build_graph(inputs["sage_src"], inputs["sage_dst"], SAGE["n"])
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       inputs[f"sage_vars_{norm}"])
    model, opt = JaxModel(_sage_conf(norm)), jax_adam(LR, 0.0)
    args = (jnp.asarray(inputs["sage_labels"]), jnp.asarray(inputs["sage_idx"]),
            jax.random.PRNGKey(7))
    runs = {"dp": jax_dp_epoch(model, opt, SAGE["batch"],
                               inputs["sage_fanouts"], dmesh, axis="dp")(
        create_train_state(variables, opt), gj,
        jax_shard_rows(dmesh, "dp", inputs["sage_x"]), *args)}
    if norm == "none":
        runs["single"] = make_sage_sampled_epoch_fn(
            model, opt, SAGE["batch"], inputs["sage_fanouts"])(
            create_train_state(variables, opt), gj,
            jnp.asarray(inputs["sage_x"]), *args)
    got_loss, got_ovf, got = port[f"sage_{norm}"]
    assert got_ovf == (False, False)
    for state, loss, _ in runs.values():
        assert abs(got_loss - float(loss)) < 1e-5
        _assert_state(got, _sage_conf(norm), jax.tree_util.tree_map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats}),
            rtol=2e-4, atol=2e-5, steps=-(-150 // SAGE["batch"]))


@pytest.mark.parametrize("crit", ["nll", "kl"])
def test_dp_mlp_epoch_matches_jax(port, inputs, jax4, crit):
    """JAX's MLP epoch on features row-sharded over 4 devices (GSPMD, the
    single-device math: global batch-norm statistics), from the same
    shuffle, no dropout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from glnn_tpu.nn.models import Model as JaxModel
    from glnn_tpu.train import create_train_state
    from glnn_tpu.train import make_adam as jax_adam
    from glnn_tpu.train import make_mlp_epoch_fn

    dmesh = jax.sharding.Mesh(jax4.devices, ("data",))
    opt = jax_adam(LR, 0.0)
    epoch = make_mlp_epoch_fn(JaxModel(_mlp_conf("batch", 0.0)), opt,
                              batch_size=MLP["batch"], criterion=crit)
    targets = inputs["mlp_labels"] if crit == "nll" else inputs["mlp_t"]
    state, loss = epoch(
        create_train_state(jax.tree_util.tree_map(jnp.asarray,
                                                  inputs["mlp_vars"]), opt),
        jax.device_put(inputs["mlp_x"],
                       NamedSharding(dmesh, PartitionSpec("data", None))),
        jnp.asarray(targets), jax.random.PRNGKey(3))
    got_loss, got = port[f"mlp_{crit}"]
    assert abs(got_loss - float(loss)) < 1e-5
    _assert_state(got, _mlp_conf("batch", 0.0), jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}),
        rtol=1e-4, atol=1e-5, steps=MLP["n"] // MLP["batch"])


def test_dp_mlp_epoch_matches_single_process(port, inputs):
    """With dropout 0.5 and batch norm: every rank draws the global batch's
    masks from a generator seeded alike, so the epoch is the port's
    single-process epoch from the same seed."""
    from glnn_tpu_torch.train import make_mlp_epoch_fn

    model = _port_model(_mlp_conf("batch", 0.5), inputs["mlp_vars"])
    opt = make_adam(model.parameters(), LR, 0.0)
    loss = make_mlp_epoch_fn(model, opt, MLP["batch"], "nll")(
        torch.from_numpy(inputs["mlp_x"]),
        torch.from_numpy(inputs["mlp_labels"]),
        torch.Generator().manual_seed(7))
    got_loss, got = port["mlp_dropout"]
    assert abs(got_loss - loss) < 1e-5
    _assert_close(got, _state(model), _mlp_conf("batch", 0.5), 1e-4, 1e-5,
                  MLP["n"] // MLP["batch"])
