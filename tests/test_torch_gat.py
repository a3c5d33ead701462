"""The port's GAT path against glnn_tpu: the plain edge ops against refops,
the fused attention's plain versions against the interpret-mode Pallas
kernels (gat_pallas.py) and the f32 oracle, the dispatcher, the GAT model,
one full-batch step, and the CLIs.

Tolerances are those of tests/test_pallas.py: the f32 edge ops at rtol 1e-5
(:368), the edge_softmax gradient at 1e-4 (:421), the fused forward at rtol
2e-2 / atol 1e-2 x max (:451; bf16 features), the fused gradients within
1e-2 of max (:489)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu import ops as jax_ops
from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.nn.models import Model as JaxModel
from glnn_tpu.ops import gat_pallas
from glnn_tpu.ops import refops as jax_refops
from glnn_tpu.train.engine import make_gnn_train_step as jax_gnn_step
from glnn_tpu.train.state import create_train_state
from glnn_tpu.train.state import make_adam as jax_make_adam
from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn import Model, from_jax_variables
from glnn_tpu_torch.ops import cuda_build, gat_cuda, refops, spmm_cuda
from glnn_tpu_torch.train import make_adam, make_gnn_train_step

N = 300


def _graphs(n=N, e=2500, seed=4, hub_free=0, plans=False):
    """The same dst-sorted graph in both packages; its first `hub_free`
    nodes receive no edges."""
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(hub_free, n, e)
    gj = jax_build_graph(src, dst, n)
    return build_graph(src, dst, n), gj.with_plans() if plans else gj


def _att(n, h, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, h, d).astype(np.float32),
            (rs.randn(h, d) * 0.3).astype(np.float32),
            (rs.randn(h, d) * 0.3).astype(np.float32))


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


# ---- the f32 plain tier against glnn_tpu.ops.refops ----------------------

@pytest.mark.parametrize("heads", [None, 3])
def test_u_add_v_matches_refops(heads):
    gt, gj = _graphs(hub_free=20)
    rs = np.random.RandomState(1)
    shape = (N,) if heads is None else (N, heads)
    a, b = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(
        np.float32)
    np.testing.assert_allclose(
        refops.u_add_v(gt, *_t(a, b)).numpy(),
        np.asarray(jax_refops.u_add_v(gj, *_j(a, b))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ops.u_add_v(gt, *_t(a, b)).numpy(),
        np.asarray(jax_refops.u_add_v(gj, *_j(a, b))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads", [None, 4])
def test_edge_softmax_and_grad_match_refops(heads):
    """Nodes 0..19 have no in-edges: no NaN anywhere."""
    gt, gj = _graphs(hub_free=20)
    rs = np.random.RandomState(2)
    shape = (gt.n_edges,) if heads is None else (gt.n_edges, heads)
    s = (rs.randn(*shape) * 3).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    st = torch.from_numpy(s).requires_grad_(True)
    got = refops.edge_softmax(gt, st)
    (got * torch.from_numpy(w)).sum().backward()
    want = jax_refops.edge_softmax(gj, jnp.asarray(s))
    dwant = jax.grad(lambda z: (jax_refops.edge_softmax(gj, z)
                                * jnp.asarray(w)).sum())(jnp.asarray(s))
    assert torch.isfinite(got).all() and torch.isfinite(st.grad).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dwant), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("heads", [None, 1, 4])
def test_softmax_plain_matches_pallas(heads):
    """The standalone softmax's autograd.Function on the CPU (the plain
    versions of edge_softmax_fwd/_bwd) against gat_pallas.edge_softmax in
    interpret mode on a planned graph: forward at 1e-5, gradient at 1e-4.
    Nodes 0..19 have no in-edges."""
    gt, gj = _graphs(hub_free=20, plans=True)
    rs = np.random.RandomState(14)
    shape = (gt.n_edges,) if heads is None else (gt.n_edges, heads)
    s = (rs.randn(*shape) * 3).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    st = torch.from_numpy(s).requires_grad_(True)
    got = gat_cuda.edge_softmax(gt, st)
    (got * torch.from_numpy(w)).sum().backward()
    want = gat_pallas.edge_softmax(gj, jnp.asarray(s))
    dwant = jax.grad(lambda z: (gat_pallas.edge_softmax(gj, z)
                                * jnp.asarray(w)).sum())(jnp.asarray(s))
    assert got.shape == st.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dwant), rtol=1e-4,
                               atol=1e-6)


def test_softmax_plain_versions_direct():
    """The plain versions' own contract: [E, H] f32 in and out, the segment
    max subtracted (finite where the scores of one segment lie far below
    another's), and the VJP ds = a da - a sum_seg(a da)."""
    gt, _ = _graphs(e=900, hub_free=30)
    s = torch.randn(gt.n_edges, 3, generator=torch.Generator().manual_seed(1))
    s[gt.receivers == gt.receivers[0]] -= 200.0     # one segment far below
    alpha = gat_cuda.edge_softmax_fwd(gt.indptr, s, N)
    dst = gt.receivers.long()
    seg = torch.zeros(N, 3).index_add_(0, dst, alpha)
    torch.testing.assert_close(seg[30:][gt.in_degrees[30:] > 0],
                               torch.ones_like(seg[30:][gt.in_degrees[30:] > 0]))
    da = torch.randn_like(alpha)
    ds = gat_cuda.edge_softmax_bwd(gt.indptr, alpha, da, N)
    t = torch.zeros(N, 3).index_add_(0, dst, alpha * da)[dst]
    torch.testing.assert_close(ds, alpha * da - alpha * t)
    with pytest.raises(TypeError):
        gat_cuda.edge_softmax_fwd(gt.indptr, s.double(), N)
    with pytest.raises(ValueError):
        gat_cuda.edge_softmax(gt, s[:-1])


@pytest.mark.parametrize("shapes", [((N, 8), (None,)), ((N, 3, 5), (3,))])
def test_u_mul_e_sum_matches_refops(shapes):
    (xshape, eshape) = shapes
    gt, gj = _graphs(hub_free=20)
    rs = np.random.RandomState(3)
    x = rs.randn(*xshape).astype(np.float32)
    e = rs.randn(gt.n_edges, *[d for d in eshape if d]).astype(np.float32)
    got = ops.u_mul_e_sum(gt, *_t(x, e)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_refops.u_mul_e_sum(gj, *_j(x, e))), rtol=1e-5,
        atol=1e-5)
    assert np.abs(got[:20]).max() == 0.0


# ---- the kernels' plain versions against the Pallas kernels -------------

def _ref_attention(g, feat, al, ar, mask_edge=None, slope=0.2):
    el = jnp.sum(feat * al[None], -1)
    er = jnp.sum(feat * ar[None], -1)
    e = jax_refops.u_add_v(g, el, er)
    e = jnp.where(e >= 0, e, slope * e)
    alpha = jax_refops.edge_softmax(g, e)
    if mask_edge is not None:
        alpha = alpha * mask_edge
    return jax_refops.u_mul_e_sum(g, feat, alpha)


def _jax_keep(gj, rng, keep, heads):
    """gat_pallas's interpret-mode dropout mask, carried from slot order to
    edge order through plan.edge_slot (test_pallas.py:504-506)."""
    plan = gj.smx
    mask_slots = jax.random.bernoulli(rng, keep, (plan.slots, heads))
    return np.array(jnp.take(mask_slots, plan.edge_slot, axis=0))


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_plain_forward_matches_pallas_and_oracle(drop):
    gt, gj = _graphs(plans=True)
    feat, al, ar = _att(N, 4, 16, 5)
    rng = jax.random.PRNGKey(42)
    keep = _jax_keep(gj, rng, 1.0 - drop, 4) if drop else None
    got = gat_cuda.gat_attention(
        gt, *_t(feat, al, ar), keep=None if keep is None else
        torch.from_numpy(keep), inv_keep=1.0 / (1.0 - drop)).numpy()
    want_pallas = np.asarray(gat_pallas.gat_attention(
        gj, *_j(feat, al, ar), drop_rate=drop,
        drop_rng=rng if drop else None))
    mask_edge = None if keep is None else jnp.asarray(
        keep.astype(np.float32) / (1.0 - drop))
    want_ref = np.asarray(_ref_attention(gj, *_j(feat, al, ar), mask_edge))
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=1e-2 * np.abs(want).max())


def _ref_rounded(g, feat, al, ar, mask_edge=None, slope=0.2):
    """The bf16-rounded oracle of test_pallas.py:469-477 (el and messages
    see bf16 feat and attn_l), with er, computed in f32, rounded once to
    bf16 as both kernels round it (gat_pallas.py:416-417): without that
    rounding an edge near the leaky_relu kink can take the other branch."""
    fr = feat.astype(jnp.bfloat16).astype(jnp.float32)
    alr = al.astype(jnp.bfloat16).astype(jnp.float32)
    el = jnp.sum(fr * alr[None], -1)
    er = jnp.sum(feat * ar[None], -1).astype(jnp.bfloat16).astype(jnp.float32)
    e = jax_refops.u_add_v(g, el, er)
    e = jnp.where(e >= 0, e, slope * e)
    alpha = jax_refops.edge_softmax(g, e)
    if mask_edge is not None:
        alpha = alpha * mask_edge
    return jax_refops.u_mul_e_sum(g, fr, alpha)


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_plain_backward_matches_pallas_grads_and_oracle(drop):
    gt, gj = _graphs(e=1800, seed=7, plans=True)
    feat, al, ar = _att(N, 2, 8, 7)
    rng = jax.random.PRNGKey(3)
    keep = _jax_keep(gj, rng, 1.0 - drop, 2) if drop else None
    mask_edge = None if keep is None else jnp.asarray(
        keep.astype(np.float32) / (1.0 - drop))

    def loss_jax(fn):
        return lambda f, a, b: jnp.sum(jnp.sin(fn(f, a, b)))

    pallas = loss_jax(lambda f, a, b: gat_pallas.gat_attention(
        gj, f, a, b, drop_rate=drop, drop_rng=rng if drop else None))
    oracle = loss_jax(lambda f, a, b: _ref_rounded(gj, f, a, b, mask_edge))
    g_pallas = jax.grad(pallas, argnums=(0, 1, 2))(*_j(feat, al, ar))
    g_oracle = jax.grad(oracle, argnums=(0, 1, 2))(*_j(feat, al, ar))

    leaves = [t.requires_grad_(True) for t in _t(feat, al, ar)]
    out = gat_cuda.gat_attention(
        gt, *leaves, keep=None if keep is None else torch.from_numpy(keep),
        inv_keep=1.0 / (1.0 - drop))
    torch.sin(out).sum().backward()
    for leaf, want_p, want_o in zip(leaves, g_pallas, g_oracle):
        got = leaf.grad.numpy()
        for want in (np.asarray(want_p), np.asarray(want_o)):
            scale = np.abs(want).max() + 1e-6
            assert np.abs(got - want).max() / scale < 1e-2


def test_plain_versions_on_zero_in_degree_rows():
    gt, _ = _graphs(hub_free=30)
    feat, al, ar = _att(N, 3, 5, 8)
    feat_b, el, er_b, al_b = gat_cuda.prep(*_t(feat, al, ar))
    out, smax, denom = gat_cuda.gat_fwd(gt.indptr, gt.senders, feat_b, el,
                                        er_b)
    assert out[:30].abs().max() == 0 and denom[:30].abs().max() == 0
    assert torch.isfinite(out).all() and (denom[30:] >= 1.0).all()
    dout = torch.randn(N, 3, 5)
    der, msg, dal = gat_cuda.gat_bwd(gt.indptr, gt.senders, feat_b, el, er_b,
                                     None, 1.0, 0.2, smax, denom, dout, al_b)
    assert der[:30].abs().max() == 0
    assert msg.shape == (gt.n_edges, 3, 5) and msg.dtype == torch.bfloat16
    assert all(torch.isfinite(t.float()).all() for t in (der, msg, dal))


def test_backward_reduces_messages_over_sources():
    """The autograd backward's source reduce (the SpMM over t_indptr /
    t_edges) equals a scatter of the messages onto their sources."""
    gt, _ = _graphs(e=900, seed=9)
    feat, al, ar = _att(N, 2, 4, 9)
    ft, alt, art = _t(feat, al, ar)
    ft.requires_grad_(True)
    dout = torch.randn(N, 2, 4)
    gat_cuda.gat_attention(gt, ft, alt, art).backward(dout)
    feat_b, el, er_b, al_b = gat_cuda.prep(ft.detach(), alt, art)
    _, smax, denom = gat_cuda.plain_gat_fwd(gt.indptr, gt.senders, feat_b,
                                            el, er_b)
    der, msg, _ = gat_cuda.plain_gat_bwd(gt.indptr, gt.senders, feat_b, el,
                                         er_b, None, 1.0, 0.2, smax, denom,
                                         dout, al_b)
    want = torch.zeros(N, 2, 4).index_add_(0, gt.senders, msg.float())
    want += der[:, :, None] * art[None]
    torch.testing.assert_close(ft.grad, want, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    gt, _ = _graphs(e=500)
    feat, al, ar = _att(N, 2, 4, 1)
    feat_b, el, er_b, _ = gat_cuda.prep(*_t(feat, al, ar))
    with pytest.raises(TypeError):
        gat_cuda.gat_fwd(gt.indptr, gt.senders, feat_b.float(), el, er_b)
    with pytest.raises(TypeError):
        gat_cuda.gat_fwd(gt.indptr.long(), gt.senders, feat_b, el, er_b)
    with pytest.raises(TypeError):
        gat_cuda.gat_fwd(gt.indptr, gt.senders, feat_b, el, er_b,
                         keep=torch.ones(gt.n_edges, 3, dtype=torch.bool))
    assert gat_cuda.supported_width(40) and gat_cuda.supported_width(127)
    assert not gat_cuda.supported_width(129)


# ---- Philox dropout and the seed mode ------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 in int64 torch against Random123's kat_vectors."""
    got = gat_cuda.philox4x32([torch.tensor([c]) for c in ctr],
                              [torch.tensor([k]) for k in key])
    assert [int(w) for w in got] == list(want)


def test_philox_keep_bits_and_statistics():
    """philox_keep's bit (e, h) is word h & 3 of Philox at counter
    (e, h >> 2, 0, 0) under key (seed lo, seed hi), kept below the JAX
    threshold; on 10**5 draws the kept share, and the joint share of two
    heads of an edge and of one head of neighbouring edges, lie within 4
    sigma of keep and keep**2."""
    keep, e, h = 0.7, 12500, 8
    seed = torch.tensor([0x299F31D0A4093822], dtype=torch.int64)
    mask = gat_cuda.philox_keep(seed, e, h, keep)
    assert mask.shape == (e, h) and mask.dtype == torch.bool
    thresh = gat_cuda.keep_threshold(keep)
    assert thresh == int(keep * 2 ** 32)
    assert gat_cuda.keep_threshold(1.0) == 2 ** 32 - 1
    for edge in (0, 1, 4321):
        for block in (0, 1):
            words = gat_cuda.philox4x32(
                [torch.tensor([c]) for c in (edge, block, 0, 0)],
                [torch.tensor([0xA4093822]), torch.tensor([0x299F31D0])])
            for k, w in enumerate(words):
                assert bool(mask[edge, 4 * block + k]) == (int(w) < thresh)
    m = mask.double()

    def within(share, p, n):
        return abs(share - p) < 4 * np.sqrt(p * (1 - p) / n)

    assert within(m.mean().item(), keep, m.numel())
    pairs = (m[:, 0::2] * m[:, 1::2]).flatten()
    assert within(pairs.mean().item(), keep ** 2, pairs.numel())
    pairs = (m[:-1:2] * m[1::2]).flatten()
    assert within(pairs.mean().item(), keep ** 2, pairs.numel())
    assert not torch.equal(mask, gat_cuda.philox_keep(seed + 1, e, h, keep))


def _slot_mask(gj, keep):
    """An edge-order keep mask carried to slot order through plan.edge_slot
    (ghost slots 0), as gat_pallas's "mask" mode takes it."""
    plan = gj.smx
    slots = np.zeros((plan.slots, keep.shape[1]), np.float32)
    slots[np.asarray(plan.edge_slot)] = keep.numpy()
    return jnp.asarray(slots, jnp.bfloat16)


@pytest.mark.parametrize("drop", [0.3, 0.5])
def test_seed_mode_layer_matches_pallas_mask_mode(drop):
    """The fused layer in seed mode (the plain versions apply philox_keep's
    mask on the CPU) against the interpret-mode Pallas layer in "mask" mode
    fed that mask: forward at rtol 2e-2 / atol 1e-2 x max, the three
    gradients within 1e-2 of max (tests/test_pallas.py:451,489)."""
    gt, gj = _graphs(e=1800, seed=7, plans=True)
    feat, al, ar = _att(N, 2, 8, 7)
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64)
    inv_keep = 1.0 / (1.0 - drop)
    mask = _slot_mask(gj, gat_cuda.philox_keep(seed, gt.n_edges, 2,
                                               1.0 - drop))

    def pallas(f, a, b):
        return gat_pallas._fused_gat(0.2, inv_keep, "mask", gj.smx, f, f, a,
                                     b, mask)

    want = np.asarray(pallas(*_j(feat, al, ar)))
    leaves = [t.requires_grad_(True) for t in _t(feat, al, ar)]
    out = gat_cuda.gat_attention(gt, *leaves, keep=seed, inv_keep=inv_keep)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-2,
                               atol=1e-2 * np.abs(want).max())
    torch.sin(out).sum().backward()
    grads = jax.grad(lambda f, a, b: jnp.sum(jnp.sin(pallas(f, a, b))),
                     argnums=(0, 1, 2))(*_j(feat, al, ar))
    for leaf, w in zip(leaves, grads):
        w = np.asarray(w)
        assert np.abs(leaf.grad.numpy() - w).max() / (np.abs(w).max()
                                                      + 1e-6) < 1e-2


@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_prep_matches_jax_rounding(h, d):
    """prep's el against the TPU kernel's score matmul (bf16 features times
    the bf16 block-diagonal attn_l, f32 sums; gat_pallas.py:118) at rtol
    1e-6 (summation order), and er against gat_pallas._prep (the f32 sum
    rounded once to bf16, :412-417) within one bf16 ulp."""
    gt, gj = _graphs(plans=True)
    feat, al, ar = _att(N, h, d, h + d)
    _, el, er_b, al_b = gat_cuda.prep(*_t(feat, al, ar))
    hdp = -(-h * d // 128) * 128
    f2 = jnp.pad(jnp.asarray(feat).reshape(N, h * d).astype(jnp.bfloat16),
                 ((0, 0), (0, hdp - h * d)))
    al_blk = gat_pallas._block_diag_al(jnp.asarray(al), hdp)
    want_el = np.asarray(jnp.dot(f2, al_blk.astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32))[:, :h]
    np.testing.assert_allclose(el.numpy(), want_el, rtol=1e-6,
                               atol=1e-6 * np.abs(want_el).max())
    er_pad, _, _ = gat_pallas._prep(gj.smx, *_j(feat, al, ar), hdp)
    want_er = np.asarray(er_pad[:N, :h].astype(jnp.float32))
    np.testing.assert_allclose(er_b.float().numpy(), want_er, rtol=2.0 ** -7,
                               atol=1e-6)
    assert torch.equal(al_b, torch.from_numpy(al).to(torch.bfloat16))


# ---- the dispatcher -------------------------------------------------------

def test_dispatcher_tiers_on_cpu():
    """auto and xla: the f32 composition (equal to JAX's on the CPU);
    pallas and pallas_int8: the fused plain versions. No kernel launches
    and no plain call counts on the CPU."""
    gt, gj = _graphs(plans=True)
    feat, al, ar = _att(N, 4, 8, 11)
    want = np.asarray(jax_ops.gat_attention(gj, *_j(feat, al, ar)))
    cuda_build.reset_counts()
    gat_cuda.reset_counts()
    for backend in ("auto", "xla"):
        ops.set_backend(backend)
        with ops.inference_mode():
            got = ops.gat_attention(gt, *_t(feat, al, ar)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fused = gat_cuda.gat_attention(gt, *_t(feat, al, ar)).numpy()
    for backend in ("pallas", "pallas_int8"):
        ops.set_backend(backend)
        with ops.inference_mode():
            got = ops.gat_attention(gt, *_t(feat, al, ar)).numpy()
        np.testing.assert_array_equal(got, fused)
    assert gat_cuda.counts == {k: 0 for k in gat_cuda.KERNELS
                               + gat_cuda.DROP_MODES}
    assert cuda_build.counts == {"plain_on_cuda": 0}


def test_dispatcher_dropout_draws_edge_mask_from_generator():
    """Dropout draws one Philox seed from the generator: the same generator
    state gives the same output and the same mask on every tier. The f32
    tier applies philox_keep's mask; the fused layer gets the seed, and on
    the CPU its plain versions apply the same mask."""
    gt, _ = _graphs()
    feat, al, ar = _t(*_att(N, 2, 4, 12))
    outs = [ops.gat_attention(gt, feat, al, ar, drop_rate=0.5,
                              gen=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(0))
    keep = gat_cuda.philox_keep(seed, gt.n_edges, 2, 0.5)
    assert 0.4 < keep.float().mean().item() < 0.6
    ops.set_backend("pallas")
    fused = ops.gat_attention(gt, feat, al, ar, drop_rate=0.5,
                              gen=torch.Generator().manual_seed(0))
    assert torch.equal(
        fused, gat_cuda.gat_attention(gt, feat, al, ar, keep=keep,
                                      inv_keep=2.0))
    assert torch.equal(
        fused, gat_cuda.gat_attention(gt, feat, al, ar, keep=seed,
                                      inv_keep=2.0))
    torch.testing.assert_close(fused, outs[0], rtol=2e-2,
                               atol=1e-2 * outs[0].abs().max().item())
    s = refops.u_add_v(gt, (feat * al[None]).sum(-1),
                       (feat * ar[None]).sum(-1))
    alpha = refops.edge_softmax(gt, torch.where(s >= 0, s, 0.2 * s))
    want = refops.u_mul_e_sum(gt, feat, alpha * keep.float() / 0.5)
    torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-6)


def test_unported_edge_kernels_raise_under_kernel_tier(monkeypatch):
    """Under a kernel tier the standalone edge_softmax and the weighted SpMM
    take their kernels (the plain versions on the CPU), in every shape of
    their contracts; on a CUDA tensor a shape outside a contract raises
    rather than falling back (read here by forcing the predicate)."""
    gt, _ = _graphs(e=400)
    rs = np.random.RandomState(13)
    s1, s2 = _t(rs.randn(gt.n_edges).astype(np.float32),
                rs.randn(gt.n_edges, 2).astype(np.float32))
    x2, w1 = _t(rs.randn(N, 3).astype(np.float32),
                rs.rand(gt.n_edges).astype(np.float32))
    x3 = torch.from_numpy(rs.randn(N, 2, 4).astype(np.float32))
    ops.set_backend("pallas")
    assert torch.equal(ops.edge_softmax(gt, s1), gat_cuda.edge_softmax(gt, s1))
    assert torch.equal(ops.edge_softmax(gt, s2), gat_cuda.edge_softmax(gt, s2))
    assert torch.equal(ops.u_mul_e_sum(gt, x2, w1),
                       spmm_cuda.u_mul_e_sum(gt, x2, w1))
    assert torch.equal(ops.u_mul_e_sum(gt, x3, s2.abs()),
                       spmm_cuda.u_mul_e_sum(gt, x3, s2.abs()))
    monkeypatch.setattr(ops, "_kernel_only", lambda x: True)
    with pytest.raises(ValueError, match="edge_softmax kernel"):
        ops.edge_softmax(gt, torch.zeros(gt.n_edges, 2, 2))
    with pytest.raises(ValueError, match="weighted SpMM kernel"):
        ops.u_mul_e_sum(gt, x2, s2)
    with pytest.raises(ValueError, match="weighted SpMM kernel"):
        ops.u_mul_e_sum(gt, x3, w1)
    monkeypatch.undo()
    assert not ops._kernel_only(torch.zeros(1))


# ---- the model and one full-batch step against glnn_tpu ------------------

def _conf(dropout=0.0, attn=0.0):
    return dict(model_name="GAT", num_layers=2, hidden_dim=16, feat_dim=12,
                label_dim=5, dropout_ratio=dropout, num_heads=4,
                attn_dropout_ratio=attn)


def _gat_setup(conf):
    gt, gj = _graphs(hub_free=10)
    x = np.random.RandomState(0).randn(N, 12).astype(np.float32)
    jm = JaxModel(conf)
    v = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x)))
    tm = Model(conf)
    from_jax_variables(v, tm)
    return jm, v, gj, tm, gt, x


def test_gat_eval_forward_matches_jax():
    jm, v, gj, tm, gt, x = _gat_setup(_conf(0.6, 0.3))
    want_list, want = jm.apply(v, gj, jnp.asarray(x), training=False)
    tm.eval()
    with torch.no_grad():
        h_list, got = tm(gt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert len(h_list) == 1 and h_list[0].shape == (N, 16)
    np.testing.assert_allclose(h_list[0].numpy(), np.asarray(want_list[0]),
                               rtol=1e-5, atol=1e-5)


def test_gat_init_and_dispatch():
    gen = torch.Generator().manual_seed(0)
    m = Model(dict(_conf(), feat_dim=300, hidden_dim=128, num_heads=8),
              gen).module
    assert [c.num_heads for c in m.convs] == [8, 1]
    w = m.convs[0].fc.weight
    assert w.shape == (128, 300) and m.convs[0].fc.bias is None
    std = np.sqrt(2.0) * np.sqrt(2.0 / (300 + 128))
    assert abs(w.std().item() - std) < 0.05 * std
    assert abs(m.convs[0].attn_l.std().item() - np.sqrt(2.0 / 16)) < 0.2
    again = Model(dict(_conf(), feat_dim=300, hidden_dim=128, num_heads=8),
                  torch.Generator().manual_seed(0)).module
    assert torch.equal(again.convs[1].attn_r, m.convs[1].attn_r)
    with pytest.raises(ValueError, match="num_layers"):
        Model(dict(_conf(), num_layers=1))


def test_gnn_train_step_matches_jax():
    """Both dropouts at 0: one full-batch NLL + Adam step gives the JAX
    loss and updated parameters."""
    conf = _conf()
    jm, v, gj, tm, gt, x = _gat_setup(conf)
    labels = np.random.RandomState(1).randint(0, 5, N)
    idx_train = np.arange(0, N, 3)
    opt = jax_make_adam(0.01, 0.01)
    state, loss_j = jax_gnn_step(jm, opt)(
        create_train_state(v, opt), gj, jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(idx_train), jax.random.PRNGKey(0))
    step = make_gnn_train_step(tm, make_adam(tm.parameters(), 0.01, 0.01))
    loss_t = step(gt, *_t(x, labels, idx_train), None)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = jax.tree_util.tree_map(np.asarray, state.params)
    for i, conv in enumerate(tm.module.convs):
        p = want[f"convs_{i}"]
        for got, ref in ((conv.fc.weight.T, p["Dense_0"]["kernel"]),
                         (conv.attn_l, p["attn_l"]),
                         (conv.attn_r, p["attn_r"])):
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                       atol=1e-6)


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


@pytest.mark.parametrize("teacher_pkg,student_pkg",
                         [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_gat_teacher_to_student(tmp_path, monkeypatch, teacher_pkg,
                                student_pkg):
    from glnn_tpu.cli import train_student as jax_student
    from glnn_tpu.cli import train_teacher as jax_teacher
    from glnn_tpu_torch.cli import train_student, train_teacher

    monkeypatch.chdir(tmp_path)
    teacher = train_teacher if teacher_pkg == "port" else jax_teacher
    student = train_student if student_pkg == "port" else jax_student
    teacher.main(_args("--teacher", "GAT"))
    _check_out(_out(tmp_path, "GAT"))
    student.main(_args("--teacher", "GAT", "--student", "MLP"))
    _check_out(_out(tmp_path, "GAT_MLP"))


def test_full_batch_sage_runs(tmp_path, monkeypatch):
    from glnn_tpu_torch.cli import train_teacher

    monkeypatch.chdir(tmp_path)
    train_teacher.main(_args("--teacher", "SAGE", "--sage_sampling", "full"))
    _check_out(_out(tmp_path, "SAGE"))
