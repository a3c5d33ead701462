"""The CUDA kernels' design, checked on the CPU: the launch geometry that
ops/spmm_cuda.py and ops/gat_cuda.py work out for the CSR SpMM and the GAT
attention backward, and mirrors of the two kernels' walks in the kernels'
order of operations.

* The SpMM mirror follows csrc/spmm_csr.cu: 32-edge chunks, edge groups
  taking every groups-th edge, column chunks of lanes * vec, and the fold
  of the groups' partial sums onto group 0. On integer rows it must equal
  the plain version exactly, on rows of 0 to 200 edges.
* The gat_bwd mirror follows csrc/gat_csr.cu in f32: one reciprocal of den
  per (row, head), per-slot sums of t and der folded as the kernel folds
  them, ds_pre = c (w g - t) per edge (c = alpha leaky_relu'), and the bf16
  message. It is held against plain_gat_bwd at the card's GAT tolerances
  (f32 outputs rtol 1e-4 / atol 1e-4 x max|want|, the message within one
  bf16 ulp) on a graph with a 150-edge hub row and large logits (attention
  scores of about randn x 10), and, through the autograd layer, against the
  interpret-mode Pallas backward, as tests/test_torch_gat.py holds
  plain_gat_bwd (1e-2 x max). The form the kernel does not take, der and
  dattn_l as differences of row sums, is shown to cancel worse where the
  attention is concentrated and dout is large.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.ops import gat_pallas
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import gat_cuda, spmm_cuda

N = 300
HUB = 150          # in-degree of row 1: several 32-edge chunks, past K
BF16, F32, INT8 = 2, 4, 1


def _graph_arrays(seed, hub_degrees=(HUB,)):
    """Random edges into rows 20.., plus rows 1, 2, ... with the given
    in-degrees from distinct sources; rows 0 and those past the hubs up to
    19 receive nothing."""
    rs = np.random.RandomState(seed)
    src = [rs.randint(0, N, 2500)]
    dst = [rs.randint(20, N, 2500)]
    for row, deg in enumerate(hub_degrees, start=1):
        src.append(rs.choice(np.arange(N), deg, replace=False))
        dst.append(np.full(deg, row))
    return np.concatenate(src), np.concatenate(dst)


# ---- the launch geometry --------------------------------------------------

@pytest.mark.parametrize("f,itemsize,want", [
    (40, BF16, (8, 5, 6)), (64, BF16, (8, 8, 4)), (128, BF16, (8, 16, 2)),
    (256, BF16, (8, 32, 1)),
    (40, F32, (4, 10, 3)), (64, F32, (4, 16, 2)), (128, F32, (4, 32, 1)),
    (256, F32, (4, 32, 1)),
    (40, INT8, (8, 5, 6)), (64, INT8, (8, 8, 4)), (128, INT8, (8, 16, 2)),
    (256, INT8, (8, 32, 1)),
])
def test_spmm_geometry(f, itemsize, want):
    """VEC is the widest load of at most 16 bytes and 8 elements that
    divides F; a row up to 32 * VEC wide takes one pass over its edges
    (groups of lanes split the edges), a wider one is split into chunks of
    32 * VEC columns, one warp each; every row stays aligned."""
    vec, lanes, groups = spmm_cuda.geometry(f, itemsize)
    assert (vec, lanes, groups) == want
    assert vec * itemsize <= 16 and vec <= 8 and f % vec == 0
    wider = 2 * vec
    assert wider * itemsize > 16 or wider > 8 or f % wider  # no wider fits
    assert lanes * groups <= 32
    passes = -(-f // (lanes * vec))
    assert passes == (1 if f <= 32 * vec else -(-f // (32 * vec)))


@pytest.mark.parametrize("f,head_width,align,want", [
    (128, 16, 16, (4, 32, 1)),    # per head at (8, 16)
    (40, 40, 16, (4, 10, 3)),     # per head at (1, 40), and APPNP's F = 40
    (15, 5, 16, (1, 15, 2)),      # (3, 5): a lane's columns share a head
    (40, None, 4, (1, 32, 1)),    # a base aligned to 4 bytes only
])
def test_spmm_geometry_weighted_and_misaligned(f, head_width, align, want):
    assert spmm_cuda.geometry(f, F32, head_width, align) == want
    assert spmm_cuda.geometry(40, BF16, align=8) == (4, 10, 3)


@pytest.mark.parametrize("heads,width,want", [
    (8, 16, (8, 1, 2, 8, 2, 32)), (1, 40, (8, 1, 5, 1, 6, 256)),
    (2, 7, (1, 1, 7, 2, 2, 128)), (4, 8, (8, 1, 1, 4, 8, 64))])
def test_gat_bwd_geometry(heads, width, want):
    """All heads share one pass over a row's edges, loads are 16 bytes
    where D allows, several edges are walked at once, and the per-edge
    terms of at least a 32-edge chunk stay in the 4 KB cache of a warp."""
    geo = gat_cuda.bwd_geometry(heads, width)
    assert tuple(geo) == want
    assert geo.hp == heads                          # one pass over the edges
    assert width % geo.vec == 0                     # rows stay aligned
    assert geo.lh * geo.reps * geo.vec >= width     # every column covered
    assert geo.hp * geo.lh * geo.slots <= 32
    assert 32 <= geo.kcache and geo.kcache * geo.hp * 16 <= 4096
    assert gat_cuda.bwd_geometry(heads, width, align=4).vec <= 2


# ---- the SpMM walk --------------------------------------------------------

def _fold(parts):
    """The kernels' fold of slot partials onto slot 0: slots [h, s) onto
    [0, s - h), halving s."""
    parts = list(parts)
    s = len(parts)
    while s > 1:
        h = (s + 1) // 2
        for q in range(s - h):
            parts[q] = parts[q] + parts[q + h]
        s = h
    return parts[0]


def _spmm_walk(indptr, indices, x, vec, lanes, groups):
    """csrc/spmm_csr.cu's walk of each row, in numpy."""
    n_rows, f = len(indptr) - 1, x.shape[1]
    out = np.zeros((n_rows, f), x.dtype)
    for row in range(n_rows):
        start, end = indptr[row], indptr[row + 1]
        for c0 in range(0, f, lanes * vec):
            cols = slice(c0, min(f, c0 + lanes * vec))
            part = np.zeros((groups, cols.stop - c0), x.dtype)
            for e0 in range(start, end, 32):
                n = min(32, end - e0)
                for j in range(-(-n // groups)):
                    for grp in range(groups):
                        k = j * groups + grp
                        if k < n:
                            part[grp] += x[indices[e0 + k], cols]
            out[row, cols] = _fold(part)
    return out


@pytest.mark.parametrize("f,itemsize", [(40, BF16), (40, F32), (64, INT8),
                                        (256, F32), (7, BF16), (1, INT8)])
def test_spmm_walk_covers_each_edge_once(f, itemsize):
    """Integer rows make the sum exact whatever the order: the walk must
    equal the plain version on rows of 0, 1, 31-33, 64, 65 and 200 edges."""
    src, dst = _graph_arrays(f, (1, 31, 32, 33, 64, 65, 200))
    g = build_graph(src, dst, N)
    x = np.random.RandomState(1).randint(-100, 100, (N, f)).astype(np.int64)
    got = _spmm_walk(g.indptr[:N + 1].numpy(), g.senders.numpy(), x,
                     *spmm_cuda.geometry(f, itemsize))
    want = torch.zeros((N, f), dtype=torch.int64).index_add_(
        0, g.receivers.long(), torch.from_numpy(x)[g.senders.long()])
    np.testing.assert_array_equal(got, want.numpy())


# ---- the GAT attention backward ----------------------------------------

def _gat_bwd_mirror(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                    slope, smax, denom, dout, al_b, row_sums=False):
    """csrc/gat_csr.cu's gat_bwd in f32 torch on the CPU, one row at a
    time: der, msg (bf16) and dattn_l. With row_sums, der and dattn_l are
    sum c w g (feat) - t sum c (feat) instead."""
    n_rows, heads = er_b.shape
    slots = gat_cuda.bwd_geometry(heads, feat_b.shape[2]).slots
    der = torch.zeros((n_rows, heads))
    msg = torch.zeros((senders.numel(),) + tuple(feat_b.shape[1:]))
    dal = torch.zeros(feat_b.shape[1:])
    al = al_b.float()

    def by_slot(values, slot):
        return _fold([values[slot == q].sum(0) for q in range(slots)])

    for v in range(n_rows):
        a, b = int(indptr[v]), int(indptr[v + 1])
        if a == b:
            continue
        slot = (torch.arange(b - a) % 32) % slots
        feat = feat_b[senders[a:b].long()].float()              # [e, H, D]
        s_pre = el[senders[a:b].long()] + er_b[v].float()
        alpha = torch.exp(torch.where(s_pre >= 0, s_pre, slope * s_pre)
                          - smax[v]) * (1.0 / denom[v])
        w = (keep[a:b].float() * inv_keep if keep is not None
             else torch.ones_like(alpha))
        wg = w * (feat * dout[v]).sum(-1)
        lk = torch.where(s_pre >= 0, torch.ones_like(s_pre),
                         torch.full_like(s_pre, slope))
        t = by_slot(alpha * wg, slot)
        ds_pre = lk * (alpha * (wg - t))
        if row_sums:
            c = lk * alpha
            der[v] = by_slot(c * wg, slot) - t * by_slot(c, slot)
            dal += (((c * wg)[..., None] * feat).sum(0)
                    - t[:, None] * (c[..., None] * feat).sum(0))
        else:
            der[v] = by_slot(ds_pre, slot)
            dal += (ds_pre[..., None] * feat).sum(0)
        msg[a:b] = ((alpha * w)[..., None] * dout[v]
                    + ds_pre[..., None] * al)
    return der, msg.to(torch.bfloat16), dal


def _gat_case(h, d, dout_scale=1.0):
    """The backward's inputs on the hub graph with large logits, row 1's
    cotangent scaled by dout_scale, and plain_gat_bwd's outputs."""
    g = build_graph(*_graph_arrays(h * d), N)
    rs = np.random.RandomState(d)
    feat = torch.from_numpy(rs.randn(N, h, d).astype(np.float32))
    # el and er of about randn x 10: concentrated attention on most rows
    al, ar = (torch.from_numpy((rs.randn(h, d) * 10 / np.sqrt(d))
                               .astype(np.float32)) for _ in range(2))
    keep = torch.from_numpy(rs.rand(g.n_edges, h) >= 0.3)
    dout = torch.from_numpy(rs.randn(N, h, d).astype(np.float32))
    dout[1] *= dout_scale
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep, 1 / 0.7, 0.2)
    _, smax, denom = gat_cuda.plain_gat_fwd(*args)
    args += (smax, denom, dout, al_b)
    return args, gat_cuda.plain_gat_bwd(*args)


def _close(got, want, rtol=1e-4, scale=1e-4):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=scale * want.abs().max().item() + 1e-12)


@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_bwd_mirror_matches_plain(h, d):
    args, want = _gat_case(h, d)
    got = _gat_bwd_mirror(*args)
    _close(got[0], want[0])
    _close(got[1], want[1], rtol=2.0 ** -7, scale=1e-5)
    _close(got[2], want[2])
    assert got[0][:1].abs().max() == 0 and got[0][10:20].abs().max() == 0


def test_gat_bwd_row_sums_cancel():
    """Why ds_pre stays per edge: with row 1's dout 1000 times the others'
    and its attention concentrated, w g - t cancels in both forms, but der
    as a difference of row sums moves more than ten times as far from the
    plain version as the per-edge sum does."""
    args, want = _gat_case(1, 40, dout_scale=1e3)
    err = [(_gat_bwd_mirror(*args, row_sums=r)[0] - want[0]).abs().max()
           for r in (False, True)]
    assert err[1] > 10 * err[0]
    _close(_gat_bwd_mirror(*args)[0], want[0])


@pytest.mark.parametrize("logit", [0.3, 3.0])
def test_gat_bwd_mirror_through_layer_matches_pallas(monkeypatch, logit):
    """The autograd layer with gat_bwd replaced by the mirror, against the
    interpret-mode Pallas gradients (1e-2 x max, tests/test_pallas.py:489)."""
    src, dst = _graph_arrays(7)
    gt, gj = build_graph(src, dst, N), jax_build_graph(src, dst,
                                                        N).with_plans()
    rs = np.random.RandomState(11)
    feat = rs.randn(N, 2, 8).astype(np.float32)
    al, ar = ((rs.randn(2, 8) * logit).astype(np.float32) for _ in range(2))

    monkeypatch.setattr(gat_cuda, "gat_bwd", lambda *a: _gat_bwd_mirror(
        *a[:10], a[10].float(), a[11]))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, al, ar)]
    torch.sin(gat_cuda.gat_attention(gt, *leaves)).sum().backward()
    want = jax.grad(lambda f, a, b: jnp.sum(jnp.sin(
        gat_pallas.gat_attention(gj, f, a, b))), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (feat, al, ar)))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        assert np.abs(leaf.grad.numpy() - w).max() / (np.abs(w).max()
                                                      + 1e-6) < 1e-2
