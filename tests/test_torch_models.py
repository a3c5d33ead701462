"""glnn_tpu_torch models against glnn_tpu with the same (JAX-initialised)
weights, carried across by `from_jax_variables`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu import ops as jax_ops
from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.nn.layers import BatchNorm1d as JaxBatchNorm1d
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn import BatchNorm1d, Model, from_jax_variables

N, F_IN, HIDDEN, CLASSES = 300, 12, 16, 5


def _conf(name, norm="batch", layers=3):
    return dict(model_name=name, num_layers=layers, hidden_dim=HIDDEN,
                feat_dim=F_IN, label_dim=CLASSES, dropout_ratio=0.0,
                norm_type=norm)


def _setup(name, norm="batch", plans=False, layers=3):
    rs = np.random.RandomState(0)
    src, dst = rs.randint(0, N, 2400), rs.randint(0, N, 2400)
    gj = jax_build_graph(src, dst, N)
    gj = gj.with_plans() if plans else gj
    x = rs.randn(N, F_IN).astype(np.float32)
    jm = JaxModel(_conf(name, norm, layers))
    variables = jm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if "batch_stats" in variables:        # non-trivial running statistics
        for st in variables["batch_stats"].values():
            st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32) * 0.3
            st["var"] = rs.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    tm = Model(_conf(name, norm, layers))
    from_jax_variables(variables, tm)
    tm.eval()
    return jm, variables, gj, tm, build_graph(src, dst, N), x


@pytest.fixture(autouse=True)
def _backends():
    yield
    jax_ops.set_backend("auto")
    ops.set_backend("auto")


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_sage_forward_matches_jax_xla(norm):
    jm, v, gj, tm, gt, x = _setup("SAGE", norm)
    jax_ops.set_backend("xla")
    want = np.asarray(jm.apply(v, gj, jnp.asarray(x), training=False)[1])
    with torch.no_grad():
        h_list, got = tm(gt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert len(h_list) == 2


def test_sage_exact_tier_matches_jax_pallas_interpret():
    jm, v, gj, tm, gt, x = _setup("SAGE", plans=True)
    jax_ops.set_backend("pallas")
    ops.set_backend("pallas")
    want = np.asarray(jm.apply(v, gj, jnp.asarray(x), training=False)[1])
    with torch.no_grad():
        got = tm(gt, torch.from_numpy(x))[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,norm", [("MLP", "batch"), ("MLP3w4", "layer"),
                                       ("GA1MLP", "none")])
def test_mlp_forward_matches_jax(name, norm):
    jm, v, gj, tm, gt, x = _setup(name, norm)
    want = jm.apply(v, None, jnp.asarray(x), training=False)
    with torch.no_grad():
        h_list, got = tm(None, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(h_list, want[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_masked_batchnorm_train_stats_match_jax():
    rs = np.random.RandomState(3)
    x = (rs.randn(64, 8) * 2 + 1).astype(np.float32)
    mask = rs.rand(64) < 0.7
    bn = JaxBatchNorm1d(use_running_average=False)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    want, upd = bn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                         mutable=["batch_stats"])
    tb = BatchNorm1d(8).train()
    got = tb(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    assert tb.momentum == 0.1


def test_init_distributions():
    gen = torch.Generator().manual_seed(0)
    conf = dict(_conf("SAGE"), feat_dim=200, hidden_dim=300)
    sage = Model(conf, gen).module
    w = sage.convs[0].fc.weight
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (200 + 300))
    assert w.abs().max().item() <= bound
    assert abs(w.std().item() - bound / math.sqrt(3)) < 0.02 * bound
    mlp = Model(dict(conf, model_name="MLP"), gen).module
    lin = mlp.layers[1]
    b = 1.0 / math.sqrt(300)
    assert lin.weight.abs().max().item() <= b and lin.bias.abs().max() <= b
    assert abs(lin.weight.std().item() - b / math.sqrt(3)) < 0.02 * b
    # the generator decides the weights
    again = Model(conf, torch.Generator().manual_seed(0)).module
    assert torch.equal(again.convs[0].fc.weight, w)


def test_model_dispatch():
    assert Model(_conf("MLP3w4")).is_mlp
    assert not Model(_conf("SAGE")).is_mlp
    assert type(Model(dict(_conf("GAT"), num_heads=4)).module).__name__ == "GAT"
    for name in ("GCN", "GCN2", "APPNP"):
        model = Model(_conf(name))
        assert type(model.module).__name__ == name.rstrip("2")
        assert not model.is_mlp
    appnp = Model(_conf("APPNP")).module
    assert (appnp.k, appnp.alpha, appnp.edge_drop) == (10, 0.1, 0.5)
    with pytest.raises(ValueError):
        Model(_conf("Transformer"))
    # compute_dtype reaches the MLP and SAGE only, as in JAX
    for name in ("MLP", "SAGE"):
        module = Model(dict(_conf(name), compute_dtype="bfloat16")).module
        assert module.dtype == torch.bfloat16
    assert not hasattr(Model(dict(_conf("GCN"), compute_dtype="bfloat16"))
                       .module, "dtype")
    with pytest.raises(ValueError, match="compute_dtype"):
        Model(dict(_conf("MLP"), compute_dtype="float16"))


def test_sampled_forward_equals_full_forward_with_full_fanout():
    from glnn_tpu_torch.sampling import sample_blocks

    jm, v, gj, tm, gt, x = _setup("SAGE", layers=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = tm(gt, xt)[1]
        seeds = torch.tensor([3, 50, 77, 299, N], dtype=torch.int32)
        max_deg = int(gt.in_degrees.max())
        blocks = sample_blocks(gt, seeds, [max_deg, max_deg],
                               torch.Generator().manual_seed(0))
        x_ext = torch.cat([xt, torch.zeros(1, F_IN)])
        got = tm(blocks, x_ext[blocks.input_nodes.long()])[1]
    torch.testing.assert_close(got[:4], full[seeds[:4].long()], rtol=1e-4,
                               atol=1e-5)
