"""glnn_tpu_torch ops against glnn_tpu: the f32 plain tier against refops,
the kernels' plain versions against the Pallas kernels in interpret mode,
and the dispatcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.ops import refops as jax_refops
from glnn_tpu.ops import spmm_pallas
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import cuda_build, refops, spmm_cuda


def _graphs(n=300, e=2500, seed=0, plans=False):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    gj = jax_build_graph(src, dst, n)
    return build_graph(src, dst, n), gj.with_plans() if plans else gj


def _x(n, f, seed):
    return np.random.RandomState(seed).randn(n, f).astype(np.float32)


@pytest.fixture(autouse=True)
def _default_backend():
    ops.set_backend("auto")
    ops.set_eval_quant(True)
    yield
    ops.set_backend("auto")
    ops.set_eval_quant(True)


@pytest.mark.parametrize("f", [1, 16, 37])
def test_plain_copy_u_sum_matches_refops(f):
    gt, gj = _graphs()
    x = _x(gt.n_nodes, f, 1)
    np.testing.assert_allclose(
        refops.copy_u_sum(gt, torch.from_numpy(x)).numpy(),
        np.asarray(jax_refops.copy_u_sum(gj, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        refops.copy_u_mean(gt, torch.from_numpy(x)).numpy(),
        np.asarray(jax_refops.copy_u_mean(gj, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,e,f", [(300, 2500, 64), (257, 1000, 100),
                                   (128, 700, 3)])
def test_exact_tier_matches_pallas_interpret(n, e, f):
    gt, gj = _graphs(n, e, seed=2, plans=True)
    x = _x(n, f, 3)
    got = spmm_cuda.copy_u_sum(gt, torch.from_numpy(x)).numpy()
    want = np.asarray(spmm_pallas.copy_u_sum(gj, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_int8_tier_equal_on_integer_features():
    gt, gj = _graphs(seed=5, plans=True)
    rs = np.random.RandomState(2)
    x = rs.randint(-127, 128, (gt.n_nodes, 32)).astype(np.float32)
    x[0, :] = 127
    got = spmm_cuda.copy_u_sum_int8(gt, torch.from_numpy(x)).numpy()
    want = np.asarray(spmm_pallas.copy_u_sum_int8(gj, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_refops.copy_u_sum(gj, jnp.asarray(x))))


def test_int8_tier_close_on_floats():
    gt, gj = _graphs(seed=6, plans=True)
    x = _x(gt.n_nodes, 48, 3)
    got = spmm_cuda.copy_u_sum_int8(gt, torch.from_numpy(x)).numpy()
    want = np.asarray(spmm_pallas.copy_u_sum_int8(gj, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quantize_cols_matches_jax():
    x = _x(200, 24, 4)
    x[:, 5] = 0.0                                # all-zero column: scale 1
    q, s = spmm_cuda.quantize_cols(torch.from_numpy(x))
    qj, sj = spmm_pallas._quantize_cols(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_gradient_matches_jax_grad(tier):
    gt, gj = _graphs(200, 1200, seed=6, plans=True)
    x, co = _x(200, 32, 6), _x(200, 32, 7)
    op_t = spmm_cuda.copy_u_sum if tier == "exact" else spmm_cuda.copy_u_sum_int8
    op_j = (spmm_pallas.copy_u_sum if tier == "exact"
            else spmm_pallas.copy_u_sum_int8)
    xt = torch.from_numpy(x).requires_grad_(True)
    (op_t(gt, xt) * torch.from_numpy(co)).sum().backward()
    want = jax.grad(lambda z: (op_j(gj, z) * jnp.asarray(co)).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=2e-2, atol=5e-2)
    # against the f32 oracle's gradient too (A^T co)
    ref = jax.grad(lambda z: (jax_refops.copy_u_sum(gj, z)
                              * jnp.asarray(co)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref),
                               rtol=2e-2, atol=5e-2)


def test_zero_degree_rows_and_odd_width():
    # every edge lands on nodes 0..9: rows 10.. have no in-edges
    rs = np.random.RandomState(4)
    g = build_graph(rs.randint(0, 60, 300), rs.randint(0, 10, 300), 60)
    x = torch.from_numpy(_x(60, 7, 5))
    for op in (spmm_cuda.copy_u_sum, spmm_cuda.copy_u_sum_int8):
        assert op(g, x)[10:].abs().max().item() == 0.0


def test_wrappers_reject_bad_inputs():
    g, _ = _graphs(50, 200)
    with pytest.raises(TypeError):
        spmm_cuda.csr_sum_bf16(g.indptr, g.senders, torch.zeros(50, 4),
                               g.n_nodes)
    with pytest.raises(TypeError):
        spmm_cuda.csr_sum_bf16(g.indptr.long(), g.senders,
                               torch.zeros(50, 4, dtype=torch.bfloat16),
                               g.n_nodes)
    with pytest.raises(TypeError):
        spmm_cuda.copy_u_sum(g, torch.zeros(50, 4, dtype=torch.float64))


def test_dispatcher_tiers_on_cpu():
    """CPU tensors: auto takes the f32 plain tier (no bf16 rounding), the
    forced kernel tiers take their plain versions, and no kernel launches."""
    gt, gj = _graphs(seed=8)
    x = _x(gt.n_nodes, 20, 9)
    xt = torch.from_numpy(x)
    ref = np.asarray(jax_refops.copy_u_sum(gj, jnp.asarray(x)))
    spmm_cuda.reset_counts()
    cuda_build.reset_counts()

    with ops.inference_mode():
        np.testing.assert_allclose(ops.copy_u_sum(gt, xt).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    ops.set_backend("pallas")
    np.testing.assert_array_equal(ops.copy_u_sum(gt, xt).numpy(),
                                  spmm_cuda.copy_u_sum(gt, xt).numpy())
    ops.set_backend("pallas_int8")
    np.testing.assert_array_equal(ops.copy_u_sum(gt, xt).numpy(),
                                  spmm_cuda.copy_u_sum_int8(gt, xt).numpy())
    ops.set_backend("xla")
    np.testing.assert_allclose(ops.copy_u_mean(gt, xt).numpy(),
                               np.asarray(jax_refops.copy_u_mean(
                                   gj, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert spmm_cuda.counts == {k: 0 for k in spmm_cuda.KERNELS}
    assert cuda_build.counts == {"plain_on_cuda": 0}
    with pytest.raises(ValueError):
        ops.set_backend("triton")


def test_tier_rule_for_cuda_tensors():
    """The selection rule for tensors on the card, read without launching."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ops._tier_selected(cuda) and not ops._tier_selected(cpu)
    assert ops.eval_quant_active(cuda) and not ops.eval_quant_active(cpu)
    assert ops._unweighted_tier() == "bf16"
    with ops.inference_mode():
        assert ops._unweighted_tier() == "int8"
        ops.set_eval_quant(False)
        assert ops._unweighted_tier() == "bf16"
        assert not ops.eval_quant_active(cuda)
    ops.set_eval_quant(True)
    ops.set_backend("pallas")
    with ops.inference_mode():
        assert ops._unweighted_tier() == "bf16"
    assert not ops.eval_quant_active(cuda)
    ops.set_backend("xla")
    assert not ops._tier_selected(cuda)
