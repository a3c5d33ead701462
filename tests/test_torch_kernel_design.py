"""The CUDA kernels' design, checked on the CPU: the launch geometry that
ops/spmm_cuda.py and ops/gat_cuda.py work out for the CSR SpMM, the GAT
attention kernels and the segment softmax, and mirrors of the kernels'
walks in the kernels' order of operations.

* The SpMM mirror follows csrc/spmm_csr.cu: 32-edge chunks, edge groups
  taking every groups-th edge, column chunks of lanes * vec, and the fold
  of the groups' partial sums onto group 0. On integer rows it must equal
  the plain version exactly, on rows of 0 to 200 edges.
* The f32 SpMM mirror follows csrc/spmm_f32.cu: rows of more than
  T = spmm_cuda.F32_CHUNK edges cut into T-edge chunks (the plan), each
  item walked in stages of G edges, lane group g summing edges g, g +
  groups, ... of each stage per column chunk, the groups folded, and each
  split row's partials summed in chunk order. On integer rows it must
  equal the plain version exactly on rows of 0, 1, T - 1, T, T + 1,
  3T + 5, 1,000 and 20,000 edges; on f32 rows it must lie within 1e-5 of
  each row's magnitude (the sum of |x| over its edges; only the order of
  the f32 sums differs) of refops.csr_sum_f32 and of JAX's
  glnn_tpu.ops.refops.copy_u_sum on the same numpy inputs.
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
* The gat_fwd mirror follows its walk in f32: per 32-edge chunk, lane j
  scores edge j for the heads of the pass; the segment max over the lanes,
  then each term exp(s - max) once; the keep bits of each edge packed into
  one word by its lane; p and p w f summed per edge slot in the feature
  layout and folded onto slot 0; one reciprocal of den per (row, head). It is held against plain_gat_fwd
  (out rtol 1e-4 / atol 1e-4 x max, the max exactly) on rows of 0 to 200
  edges, a 150-edge hub row among them, with large logits, without
  dropout and in seed mode.
* The edge_softmax_fwd mirror packs 32 / (g p) consecutive rows into a
  warp, reads a row of at most p r edges once into registers and sums it
  with the kernel's butterfly, and walks longer rows with the whole warp
  (max, then a compensated sum); it is held against plain_edge_softmax_fwd
  (rtol 1e-5) and counts the reads of every score.
* With hub rows split across warps (rows of more than T =
  spmm_cuda.HUB_CHUNK edges, hub_walks.HUB_SPLIT: 0 to 20 T edges), the
  walks of tests/hub_walks.py: the template body's and gat_fwd's, and
  gat_bwd's (each chunk's part of t, t in chunk order, ds_pre per edge,
  der per chunk in chunk order), edge_softmax_fwd's (chunk maxima, chunk
  sums with the row's max) and edge_softmax_bwd's (each chunk's part of
  t, t in chunk order, ds per edge). Each is held to its plain version and
  to its unsplit walk at the card's tolerances (the GAT walks also at the
  GAT layer's T = gat_cuda.GAT_CHUNK), and through the autograd layer
  (gat_fwd and gat_bwd both walked at the layer's T) to glnn_tpu: the
  interpret-mode Pallas kernels on rows of up to 2 T + 3 edges, its XLA
  tier on the 20 T row, at 1e-2 x max; the softmax walks to
  refops.edge_softmax and the interpret-mode gat_pallas.edge_softmax and
  their gradients. The layer's forward and backward take the CSR's kept
  GAT plan, the softmax's forward and backward its kept plan at
  HUB_CHUNK, each built once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glnn_tpu.graph.container import build_graph as jax_build_graph
from glnn_tpu.ops import gat_pallas
from glnn_tpu.ops import refops as jax_refops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import gat_cuda, refops, spmm_cuda

import hub_walks

N = 300
HUB = 150          # in-degree of row 1: several 32-edge chunks, past K
BF16, F32, INT8 = 2, 4, 1


def _graph_arrays(seed, hub_degrees=(HUB,), n=N, n_random=2500):
    """n_random random edges into rows 20.. of n, plus rows 1, 2, ... with
    the given in-degrees from distinct sources; rows 0 and those past the
    hubs up to 19 receive nothing."""
    rs = np.random.RandomState(seed)
    src = [rs.randint(0, n, n_random)]
    dst = [rs.randint(20, n, n_random)]
    for row, deg in enumerate(hub_degrees, start=1):
        src.append(rs.choice(np.arange(n), deg, replace=False))
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


@pytest.mark.parametrize("heads,width,want", [
    (8, 16, (8, 1, 2, 8, 2)), (1, 40, (4, 1, 10, 1, 3)),
    (2, 7, (1, 1, 7, 2, 2)), (16, 8, (8, 1, 1, 8, 4)), (1, 16, (8, 1, 2, 1, 16))])
def test_gat_fwd_geometry(heads, width, want):
    """gat_fwd lays lanes out as gat_bwd does ((8, 16): 16 lanes per edge
    and 2 slots), with at most 8 heads per pass and, where an 8-byte load
    allows it, at most 4 slots ((1, 40): 10 lanes per edge and 3 slots,
    where gat_bwd takes 5 and 6)."""
    geo = gat_cuda.fwd_geometry(heads, width)
    assert tuple(geo) == want
    assert geo.hp <= gat_cuda.FWD_MAX_HEADS
    assert geo.hp * geo.lh * geo.slots <= 32
    assert width % geo.vec == 0 and geo.lh * geo.reps * geo.vec >= width


@pytest.mark.parametrize("heads,n_edges,n_rows,want", [
    (1, 2537353, 169343, (1, 4, 8)), (8, 2537353, 169343, (8, 4, 8)),
    (3, 3000, 300, (4, 4, 8)), (40, 3000, 300, (32, 1, 8))])
def test_softmax_geometry(heads, n_edges, n_rows, want):
    """[E, 1] on the smoke graph packs 8 rows into a warp and [E, 8] one,
    each holding a row of up to 32 edges (twice the mean in-degree, 15.0)
    in 8 registers per lane."""
    geo = gat_cuda.softmax_geometry(heads, n_edges, n_rows)
    assert tuple(geo) == want
    assert geo.g * geo.p <= 32 and 32 % (geo.g * geo.p) == 0


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


# ---- the f32 SpMM: geometry, plan and walk --------------------------------

T = spmm_cuda.F32_CHUNK
SPLIT_DEGREES = (0, 1, T - 1, T, T + 1, 3 * T + 5, 1000, 20000)


@pytest.mark.parametrize("f,align,want", [
    (128, 16, (4, 128, 1, 4)), (100, 16, (4, 100, 1, 5)),
    (40, 16, (4, 40, 3, 12)), (64, 16, (4, 64, 2, 8)),
    (256, 16, (4, 128, 1, 4)), (300, 16, (4, 100, 1, 5)),
    (7, 16, (1, 7, 4, 18)), (1, 16, (1, 1, 32, 32)), (2, 16, (2, 2, 32, 32)),
    (128, 8, (2, 64, 1, 4)), (100, 4, (1, 25, 1, 5)),
])
def test_f32_geometry(f, align, want):
    """The widest copy of at most 16 bytes that divides F and keeps rows
    aligned; column chunks of at most 32 pieces, equal but for the last;
    G edges a stage such that the stage's copies fill the copy steps: at
    F = 128 and 100 no more than 3 of a stage's 128 lane copies are
    idle, where the template body's layout left 7 of 32 lanes idle on
    every step at F = 100."""
    geo = spmm_cuda.f32_geometry(f, align)
    assert tuple(geo) == want
    q = geo.width // geo.vec
    assert f % geo.vec == 0 and align % (4 * geo.vec) == 0 and q <= 32
    assert -(-f // geo.width) == -(-(f // geo.vec) // 32)   # fewest chunks
    assert geo.groups * q <= 32 < (geo.groups + 1) * q
    copies = geo.stage_edges * q
    assert geo.stage_edges <= 32 and -(-copies // 32) <= spmm_cuda.F32_COPIES
    if f in (100, 128) and align == 16:
        assert 32 * -(-copies // 32) - copies <= 3


def _split_graph(seed, f_rows=20, n=300, n_random=2500):
    """n_random random edges into rows len(SPLIT_DEGREES).. of n, and rows
    0, 1, ... with SPLIT_DEGREES in-edges from random sources (repeats
    allowed: a 20,000-edge row over 300 nodes)."""
    rs = np.random.RandomState(seed)
    k = len(SPLIT_DEGREES)
    src = [rs.randint(0, n, n_random)] + [rs.randint(0, n, d)
                                          for d in SPLIT_DEGREES]
    dst = [rs.randint(k, n, n_random)] + [np.full(d, row) for row, d
                                          in enumerate(SPLIT_DEGREES)]
    return np.concatenate(src), np.concatenate(dst), n


def _f32_walk(indptr, indices, x, geo, chunk):
    """csrc/spmm_f32.cu's walk of each row (and each split row's chunks,
    then their partials in chunk order), in numpy."""
    n_rows, f = len(indptr) - 1, x.shape[1]
    _, width, groups, stage = geo

    def item(begin, end):
        res = np.zeros(f, x.dtype)
        for c0 in range(0, f, width):
            cols = slice(c0, min(f, c0 + width))
            part = np.zeros((groups, cols.stop - c0), x.dtype)
            for s0 in range(begin, end, stage):
                n = min(stage, end - s0)
                for grp in range(groups):
                    for j in range(grp, n, groups):
                        part[grp] += x[indices[s0 + j], cols]
            res[cols] = _fold(part)
        return res

    out = np.zeros((n_rows, f), x.dtype)
    for row in range(n_rows):
        begin, end = int(indptr[row]), int(indptr[row + 1])
        if end - begin <= chunk:
            out[row] = item(begin, end)
            continue
        acc = np.zeros(f, x.dtype)
        for c in range(begin, end, chunk):
            acc = acc + item(c, min(end, c + chunk))
        out[row] = acc
    return out


def test_f32_plan_cuts_each_split_row():
    """The plan lists exactly the rows of more than T edges, in order, and
    tiles each with chunks of T edges but the last."""
    src, dst, n = _split_graph(0)
    g = build_graph(src, dst, n)
    plan = spmm_cuda.hub_plan(g.indptr, n, T)
    assert plan.rows.tolist() == [i for i, d in enumerate(SPLIT_DEGREES)
                                  if d > T]
    assert plan.chunk == T and plan.n_chunks == plan.chunks.shape[0]
    ip = g.indptr.tolist()
    for s, row in enumerate(plan.rows.tolist()):
        ranges = plan.chunks[plan.first[s]:plan.first[s + 1]].tolist()
        assert ranges[0][0] == ip[row] and ranges[-1][1] == ip[row + 1]
        assert all(b - a == T for a, b in ranges[:-1])
        assert all(r[1] == q[0] for r, q in zip(ranges, ranges[1:]))
        assert 0 < ranges[-1][1] - ranges[-1][0] <= T
    assert spmm_cuda.graph_f32_plan(g) is spmm_cuda.graph_f32_plan(g)


@pytest.mark.parametrize("f", [128, 100, 40, 7, 1, 300])
def test_f32_walk_covers_each_edge_once(f):
    """Integer rows make the sum exact whatever the order: the walk must
    equal the plain version on rows of 0 to 20,000 edges, on the forward
    and the transposed walk."""
    src, dst, n = _split_graph(f)
    g = build_graph(src, dst, n)
    x = np.random.RandomState(1).randint(-100, 100, (n, f)).astype(np.int64)
    geo = spmm_cuda.f32_geometry(f)
    for indptr, cols in ((g.indptr, g.senders), (g.t_indptr, g.t_receivers)):
        got = _f32_walk(indptr[:n + 1].numpy(), cols.numpy(), x, geo, T)
        want = torch.zeros((n, f), dtype=torch.int64).index_add_(
            0, torch.from_numpy(np.repeat(np.arange(n), np.diff(
                indptr[:n + 1].numpy()))), torch.from_numpy(x)[cols.long()])
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("f", [128, 100, 7])
def test_f32_walk_matches_plain_and_jax(f):
    """On f32 rows the walk lies within 1e-5 of each row's magnitude of
    refops.csr_sum_f32 and of glnn_tpu.ops.refops.copy_u_sum (JAX on the
    CPU), all three from the same numpy inputs."""
    src, dst, n = _split_graph(f + 3)
    g = build_graph(src, dst, n)
    x = np.random.RandomState(2).randn(n, f).astype(np.float32)
    got = _f32_walk(g.indptr[:n + 1].numpy(), g.senders.numpy(), x,
                    spmm_cuda.f32_geometry(f), T)
    xt = torch.from_numpy(x)
    magnitude = refops.csr_sum_f32(g.indptr, g.senders, xt.abs(), n).numpy()
    plain = refops.csr_sum_f32(g.indptr, g.senders, xt, n).numpy()
    jax_sum = np.asarray(jax_refops.copy_u_sum(jax_build_graph(src, dst, n),
                                               jnp.asarray(x)))
    for want in (plain, jax_sum):
        assert np.all(np.abs(got - want) <= 1e-5 * magnitude)
    assert np.abs(got[len(SPLIT_DEGREES) - 1]).max() > 0   # the 20,000 row


# ---- hub rows split across warps: the template body and gat_fwd ----------

HT = spmm_cuda.HUB_CHUNK
HUB_SPLIT = hub_walks.HUB_SPLIT


def _walks(g):
    """(indptr, indices, widx) of the forward and the transposed walk."""
    return ((g.indptr, g.senders, None),
            (g.t_indptr, g.t_receivers, g.t_edges))


@pytest.mark.parametrize("chunk", [32, 256, HT, 1024])
def test_hub_plan_cuts_each_split_row(chunk):
    """On both walks the plan lists exactly the rows of more than T edges,
    in order, tiles each with chunks of T edges but the last, and names
    each chunk's row (owner): every edge of a split row in one chunk. The
    graph's plan is built once and kept (plan_of), and counted once."""
    src, dst, n = hub_walks.hub_split_arrays(chunk)
    g = build_graph(src, dst, n)
    for name, (indptr, _, _) in zip(("indptr", "t_indptr"), _walks(g)):
        ip = indptr[:n + 1].tolist()
        plan = spmm_cuda.hub_plan(indptr, n, chunk)
        deg = np.diff(ip)
        assert plan.rows.tolist() == np.nonzero(deg > chunk)[0].tolist()
        assert (plan.chunk, plan.n_rows) == (chunk, n)
        assert plan.n_chunks == plan.chunks.shape[0] == plan.owner.numel()
        covered = np.zeros(ip[-1], np.int64)
        for s, row in enumerate(plan.rows.tolist()):
            lo, hi = plan.first[s].item(), plan.first[s + 1].item()
            ranges = plan.chunks[lo:hi].tolist()
            assert plan.owner[lo:hi].tolist() == [s] * (hi - lo)
            assert ranges[0][0] == ip[row] and ranges[-1][1] == ip[row + 1]
            assert all(b - a == chunk for a, b in ranges[:-1])
            assert 0 < ranges[-1][1] - ranges[-1][0] <= chunk
            for a, b in ranges:
                covered[a:b] += 1
        split = np.repeat(deg > chunk, deg)
        assert (covered[split] == 1).all() and (covered[~split] == 0).all()
        before = spmm_cuda.builds["hub_plan"]
        kept = spmm_cuda.plan_of(g, name, n, chunk)
        assert spmm_cuda.plan_of(g, name, n, chunk) is kept
        assert spmm_cuda.builds["hub_plan"] == before + 1
        assert torch.equal(kept.chunks, plan.chunks)
    assert g.to("cpu").cache == {}                     # a moved graph's own


def _template_case(policy, f, seed, integer):
    """The inputs of one template policy on the hub-split graph: x (and
    the int8 scale, the weights), integer-valued where `integer`."""
    src, dst, n = hub_walks.hub_split_arrays(seed)
    g = build_graph(src, dst, n)
    rs = np.random.RandomState(seed + 1)
    if integer:
        x = rs.randint(-100, 100, (n, f)).astype(np.float32)
        w = rs.randint(0, 3, g.n_edges).astype(np.float32)
    else:
        x = rs.randn(n, f).astype(np.float32)
        w = (rs.rand(g.n_edges) * 2).astype(np.float32)
    return g, x, w


def _template_pair(policy, g, x, w, indptr, indices, widx):
    """(mirror, plain version) of one walk of `policy`, f32 numpy."""
    n, f = g.n_nodes, x.shape[1]
    xt = torch.from_numpy(x)
    if policy == "bf16":
        xb = spmm_cuda.to_message(xt)
        mirror = hub_walks.template_walk(
            indptr[:n + 1].numpy(), indices.numpy(), xb.float().numpy(), n,
            spmm_cuda.geometry(f, BF16), HT)
        plain = spmm_cuda.plain_csr_sum_bf16(indptr, indices, xb, n)
    elif policy == "int8":
        q, s = spmm_cuda.quantize_cols(xt)
        mirror = hub_walks.template_walk(
            indptr[:n + 1].numpy(), indices.numpy(), q.numpy(), n,
            spmm_cuda.geometry(f, INT8), HT, "int8", scale=s.numpy())
        plain = spmm_cuda.plain_csr_sum_int8(indptr, indices, q, s, n)
    else:
        wt = torch.from_numpy(w)
        mirror = hub_walks.template_walk(
            indptr[:n + 1].numpy(), indices.numpy(), x, n,
            spmm_cuda.geometry(f, F32, f), HT, "weighted", w=w,
            widx=None if widx is None else widx.numpy())
        plain = spmm_cuda.plain_csr_wsum_bf16(indptr, indices, widx, xt, wt,
                                              n)
    return mirror, plain.numpy()


@pytest.mark.parametrize("f", [40, 128, 7, 300])
@pytest.mark.parametrize("policy", ["bf16", "int8", "weighted"])
def test_template_walk_covers_each_edge_once(policy, f):
    """Integer rows make every sum exact whatever the order: on rows of 0,
    1, T - 1, T, T + 1 and 20 T edges, forward and transposed, the split
    walk (chunks, then their partials in chunk order) equals the plain
    version bit for bit."""
    g, x, w = _template_case(policy, f, f, integer=True)
    for indptr, indices, widx in _walks(g):
        mirror, plain = _template_pair(policy, g, x, w, indptr, indices,
                                       widx)
        np.testing.assert_array_equal(mirror, plain)
        assert np.abs(mirror[len(HUB_SPLIT) - 1]).max() > 0   # 20 T edges


@pytest.mark.parametrize("f", [40, 128, 7])
@pytest.mark.parametrize("policy", ["bf16", "int8", "weighted"])
def test_template_walk_matches_plain(policy, f):
    """On random rows the f32 sums of the split walk differ from the plain
    version's in order only: each element within 1e-5 of its row's
    magnitude (the same sum over |x| and |w|), as the f32 sum's walk is
    held (a fixed rtol does not fit sums of 10,240 terms that cancel);
    the int8 sums are exact, so equal. Where the orders agree (rows of
    one edge, F wide enough that groups == 1), bit for bit."""
    g, x, w = _template_case(policy, f, f + 5, integer=False)
    for indptr, indices, widx in _walks(g):
        mirror, plain = _template_pair(policy, g, x, w, indptr, indices,
                                       widx)
        if policy == "int8":
            np.testing.assert_array_equal(mirror, plain)
        else:
            _, magnitude = _template_pair(policy, g, np.abs(x), np.abs(w),
                                          indptr, indices, widx)
            assert np.all(np.abs(mirror - plain) <= 1e-5 * magnitude)
        deg = np.diff(indptr[:g.n_nodes + 1].numpy())
        if spmm_cuda.geometry(f, 2)[2] == 1:
            one = np.nonzero(deg == 1)[0]
            np.testing.assert_array_equal(mirror[one], plain[one])


def _jax_plans_tiled(gj):
    """Every forward and backward SpMM plan of gj is a tiled one (the
    skewed graph sends build_block_plan back to spmm_pallas._kernel)."""
    plans = []
    for p in gj.plans:
        plans.extend(p if isinstance(p, (tuple, list)) else [p])
    return all(p.tiles_per_block is None for p in plans)


@pytest.mark.parametrize("f", [40, 128])
def test_template_walk_matches_jax(f):
    """The split walk of the exact tier and of the int8 tier against JAX
    on the same numpy inputs: spmm_pallas.copy_u_sum / copy_u_sum_int8 in
    interpret mode, whose plans on this graph are the tiled kernel's
    (spmm_pallas._kernel, the TPU's answer to hub rows), and refops'
    f32 sum; the weighted walk against spmm_pallas.u_mul_e_sum."""
    from glnn_tpu.ops import spmm_pallas

    src, dst, n = hub_walks.hub_split_arrays(f + 11)
    g = build_graph(src, dst, n)
    gj = jax_build_graph(src, dst, n).with_plans()
    assert _jax_plans_tiled(gj)
    rs = np.random.RandomState(f)
    x = rs.randn(n, f).astype(np.float32)
    w = (rs.rand(g.n_edges) * 2).astype(np.float32)
    xj = jnp.asarray(x)
    bf16, _ = _template_pair("bf16", g, x, w, g.indptr, g.senders, None)
    int8, _ = _template_pair("int8", g, x, w, g.indptr, g.senders, None)
    wsum, _ = _template_pair("weighted", g, x, w, g.indptr, g.senders, None)
    np.testing.assert_allclose(
        bf16, np.asarray(spmm_pallas.copy_u_sum(gj, xj)), rtol=1e-5,
        atol=1e-4)
    np.testing.assert_array_equal(
        int8, np.asarray(spmm_pallas.copy_u_sum_int8(gj, xj)))
    np.testing.assert_allclose(
        wsum, np.asarray(spmm_pallas.u_mul_e_sum(gj, xj, jnp.asarray(w))),
        rtol=1e-5, atol=1e-4)
    # the f32 oracle at the Pallas tests' bf16 tolerance
    np.testing.assert_allclose(
        bf16, np.asarray(jax_refops.copy_u_sum(gj, xj)), rtol=2e-2,
        atol=5e-2 * np.sqrt(np.diff(g.indptr[:n + 1].numpy())).max())


def _gat_split_case(h, d, drop, seed, degrees=HUB_SPLIT):
    """gat_fwd's inputs on the hub-split graph (rows of `degrees` edges)
    with large logits (about randn x 10), in seed mode or without
    dropout."""
    src, dst, n = hub_walks.hub_split_arrays(seed, degrees)
    g = build_graph(src, dst, n)
    rs = np.random.RandomState(seed)
    feat = torch.from_numpy(rs.randn(n, h, d).astype(np.float32))
    al, ar = (torch.from_numpy((rs.randn(h, d) * 10 / np.sqrt(d))
                               .astype(np.float32)) for _ in range(2))
    feat_b, el, er_b, _ = gat_cuda.prep(feat, al, ar)
    keep = (torch.tensor([987654321], dtype=torch.int64) if drop == "seed"
            else None)
    return g, (g.indptr, g.senders, feat_b, el, er_b, keep, 1 / 0.7, 0.2)


GT = gat_cuda.GAT_CHUNK
# HUB_SPLIT's degrees about the GAT layer's T
GAT_SPLIT = (0, 1, GT - 1, GT, GT + 1, 20 * GT)


def _gat_fwd_split_walk(h, d, drop, seed, chunk, degrees):
    """gat_fwd's split walk at T = chunk on rows of `degrees` edges, held
    to plain_gat_fwd and to the unsplit walk (see the tests below)."""
    g, args = _gat_split_case(h, d, drop, seed, degrees)
    got = hub_walks.gat_fwd_walk(*args, chunk)
    want = gat_cuda.plain_gat_fwd(*args)
    whole = hub_walks.gat_fwd_walk(*args, 10 ** 9)
    short = torch.from_numpy(np.diff(g.indptr[:g.n_nodes + 1].numpy())
                             <= chunk)
    for other in (want, whole):
        _close(got[0], other[0])
        assert torch.equal(got[1], other[1])
        _close(got[2][short], other[2][short], rtol=1e-5, scale=1e-6)
        # den of the split rows: sums of up to 10,240 positive terms in
        # another order, within 1e-4 of themselves
        torch.testing.assert_close(got[2][~short], other[2][~short],
                                   rtol=1e-4, atol=0)
    assert torch.equal(got[0][short], whole[0][short])
    assert torch.equal(got[2][short], whole[2][short])
    assert got[0][0].abs().max() == 0 and got[2][0].abs().max() == 0
    assert got[2][len(degrees) - 1].min() >= 1        # den >= 1 when split


@pytest.mark.parametrize("drop", ["none", "seed"])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_fwd_split_walk_matches_plain(h, d, drop):
    """gat_fwd with rows of 0 to 20 T edges split: each chunk's terms with
    its row's final max, den and p w f summed per chunk, then in chunk
    order. Against plain_gat_fwd at the card's tolerance (out rtol 1e-4 /
    atol 1e-4 x max, den 1e-5), the max bit for bit; and against the
    unsplit walk (the same rows walked by one warp each): only the order
    of the sums differs."""
    _gat_fwd_split_walk(h, d, drop, h * d, HT, HUB_SPLIT)


@pytest.mark.parametrize("drop", ["none", "seed"])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_fwd_split_walk_at_gat_chunk_matches_plain(h, d, drop):
    """The same at the GAT layer's T = GAT_CHUNK, on rows of 0 to 20 of
    those T edges."""
    _gat_fwd_split_walk(h, d, drop, h * d + 2, GT, GAT_SPLIT)


@pytest.mark.parametrize("logit", [0.3, 3.0])
def test_gat_fwd_split_walk_through_layer_matches_pallas(monkeypatch, logit):
    """The autograd layer with gat_fwd replaced by the split walk (at the
    T of the layer's kept plan), against glnn_tpu's gat_attention on the
    same numpy inputs (its fused kernel
    in interpret mode where the graph has an attention plan, else its XLA
    tier) at 1e-2 x max, as tests/test_torch_gat.py holds plain_gat_fwd;
    and the layer's gradients (gat_bwd's plain version on the split
    forward's max and den) likewise. Rows of up to 2 T + 3 edges, so that
    every dst block's in-edges fit JAX's attention plan (X_MAX = 4,096)
    and its fused kernel runs."""
    src, dst, n = hub_walks.hub_split_arrays(7, (0, 1, HT - 1, HT, HT + 1, 2 * HT + 3),
                                    n=2048, n_random=2000)
    gt = build_graph(src, dst, n)
    gj = jax_build_graph(src, dst, n).with_plans()
    assert gj.smx is not None
    rs = np.random.RandomState(12)
    feat = rs.randn(n, 2, 8).astype(np.float32)
    al, ar = ((rs.randn(2, 8) * logit).astype(np.float32) for _ in range(2))

    monkeypatch.setattr(gat_cuda, "gat_fwd", lambda *a, **k: (
        hub_walks.gat_fwd_walk(*a[:8], k["plan"].chunk)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, al, ar)]
    out = gat_cuda.gat_attention(gt, *leaves)
    torch.sin(out).sum().backward()
    fn = lambda f, a, b: gat_pallas.gat_attention(gj, f, a, b)  # noqa: E731
    want = np.asarray(fn(*(jnp.asarray(a) for a in (feat, al, ar))))
    assert np.abs(out.detach().numpy() - want).max() / np.abs(want).max() \
        < 1e-2
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (feat, al, ar)))
    for leaf, w in zip(leaves, grads):
        w = np.asarray(w)
        assert np.abs(leaf.grad.numpy() - w).max() / (np.abs(w).max()
                                                      + 1e-6) < 1e-2


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

    monkeypatch.setattr(gat_cuda, "gat_bwd", lambda *a, **k: _gat_bwd_mirror(
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


# ---- hub rows split across warps in gat_bwd and the segment softmax ----

def _gat_bwd_split_case(h, d, drop, seed, degrees=HUB_SPLIT):
    """gat_bwd's inputs on the hub-split graph (rows of `degrees` edges,
    by default 0 to 20 T) with large logits, seed mode or no dropout:
    _gat_split_case's, the plain forward's max and den, a cotangent and
    the bf16 attn_l."""
    g, args = _gat_split_case(h, d, drop, seed, degrees)
    rs = np.random.RandomState(seed)      # _gat_split_case's draws again
    rs.randn(g.n_nodes, h, d)
    al_b = torch.from_numpy((rs.randn(h, d) * 10 / np.sqrt(d))
                            .astype(np.float32)).to(torch.bfloat16)
    _, smax, denom = gat_cuda.plain_gat_fwd(*args)
    dout = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        g.n_nodes, h, d).astype(np.float32))
    return g, args + (smax, denom, dout, al_b)


def _gat_bwd_split_walk(h, d, drop, seed, chunk, degrees):
    """gat_bwd's split walk at T = chunk on rows of `degrees` edges, held
    to plain_gat_bwd and to the unsplit walk (see the tests below)."""
    g, args = _gat_bwd_split_case(h, d, drop, seed, degrees)
    got = hub_walks.gat_bwd_walk(*args, chunk)
    whole = hub_walks.gat_bwd_walk(*args, 10 ** 9)
    want = gat_cuda.plain_gat_bwd(*args)
    for other in (want, whole):
        _close(got[0], other[0])
        _close(got[1], other[1], rtol=2.0 ** -7, scale=1e-5)
        _close(got[2], other[2])
    deg = torch.from_numpy(np.diff(g.indptr[:g.n_nodes + 1].numpy()))
    short = deg <= chunk
    assert torch.equal(got[0][short], whole[0][short])
    edge_short = short[g.receivers.long()]
    assert torch.equal(got[1][edge_short], whole[1][edge_short])
    assert got[0][0].abs().max() == 0
    assert got[0][len(degrees) - 1].abs().max() > 0


@pytest.mark.parametrize("drop", ["none", "seed"])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_bwd_split_walk_matches_plain(h, d, drop):
    """gat_bwd with rows of 0 to 20 T edges split: each chunk's part of t,
    t summed in chunk order by every chunk, ds_pre per edge, der per chunk
    summed in chunk order. Against plain_gat_bwd and the unsplit walk at
    the card's tolerances (der and dattn_l rtol 1e-4 / atol 1e-4 x max, the
    message within a bf16 ulp); rows of at most T edges are the unsplit
    walk's bit for bit."""
    _gat_bwd_split_walk(h, d, drop, h * d + 1, HT, HUB_SPLIT)


@pytest.mark.parametrize("drop", ["none", "seed"])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5)])
def test_gat_bwd_split_walk_at_gat_chunk_matches_plain(h, d, drop):
    """The same at the GAT layer's T = GAT_CHUNK, on rows of 0 to 20 of
    those T edges."""
    _gat_bwd_split_walk(h, d, drop, h * d + 3, GT, GAT_SPLIT)


def _layer_grads(gt, fn, feat, al, ar):
    """The port's layer (its kernels' plain versions or walks, as patched)
    and `fn` (JAX's) on the same numpy inputs: out and the gradients of
    sum(sin(out)), each pair held at 1e-2 x max."""
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, al, ar)]
    out = gat_cuda.gat_attention(gt, *leaves)
    torch.sin(out).sum().backward()
    want = np.asarray(fn(*(jnp.asarray(a) for a in (feat, al, ar))))
    assert np.abs(out.detach().numpy() - want).max() / np.abs(want).max() \
        < 1e-2
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (feat, al, ar)))
    for leaf, w in zip(leaves, grads):
        w = np.asarray(w)
        assert np.abs(leaf.grad.numpy() - w).max() / (np.abs(w).max()
                                                      + 1e-6) < 1e-2


def _patch_split_walks(monkeypatch):
    """gat_fwd and gat_bwd replaced by their split walks at the T of the
    plan the layer hands them (its kept plan, T = GAT_CHUNK)."""
    def chunk(k):
        assert k["plan"].chunk == GT
        return k["plan"].chunk

    monkeypatch.setattr(gat_cuda, "gat_fwd", lambda *a, **k: (
        hub_walks.gat_fwd_walk(*a[:8], chunk(k))))
    monkeypatch.setattr(gat_cuda, "gat_bwd", lambda *a, **k: (
        hub_walks.gat_bwd_walk(*a[:12], chunk(k))))


@pytest.mark.parametrize("logit", [0.3, 3.0])
def test_gat_bwd_split_walk_through_layer_matches_pallas(monkeypatch, logit):
    """The autograd layer with gat_fwd and gat_bwd replaced by their split
    walks, against glnn_tpu's fused layer (interpret-mode Pallas, forward
    and backward kernels) on rows of up to 2 T + 3 edges, whose dst blocks
    fit JAX's attention plan: out and gradients at 1e-2 x max."""
    src, dst, n = hub_walks.hub_split_arrays(
        8, (0, 1, HT - 1, HT, HT + 1, 2 * HT + 3), n=2048, n_random=2000)
    gt = build_graph(src, dst, n)
    gj = jax_build_graph(src, dst, n).with_plans()
    assert gj.smx is not None
    rs = np.random.RandomState(13)
    feat = rs.randn(n, 2, 8).astype(np.float32)
    al, ar = ((rs.randn(2, 8) * logit).astype(np.float32) for _ in range(2))
    _patch_split_walks(monkeypatch)
    _layer_grads(gt, lambda f, a, b: gat_pallas.gat_attention(gj, f, a, b),
                 feat, al, ar)


def _bf16_forward(x):
    """x rounded to bf16 in the forward, the identity in the backward."""
    return x + jax.lax.stop_gradient(
        x.astype(jnp.bfloat16).astype(jnp.float32) - x)


@pytest.mark.parametrize("logit", [0.3, 3.0])
def test_gat_bwd_split_walk_through_layer_matches_xla_tier(monkeypatch,
                                                           logit):
    """The same on hub_walks.HUB_SPLIT's rows (one of 20 T edges), where
    JAX has no attention plan (a dst block past X_MAX) and composes its
    XLA tier (glnn_tpu/ops/__init__.py:205-220: refops.u_add_v,
    edge_softmax, u_mul_e_sum): out and gradients at 1e-2 x max. That tier
    forms el and er in f32, where JAX's fused tier and the port take el of
    bf16 features and bf16 attn_l (gat_pallas.py:118) and round er once
    to bf16 (`_prep`, :409-420); on the 10,240-edge row the er rounding
    alone moves dattn_r by 2.4e-2 (logit 0.3) and 1.2e-1 (logit 3) of its
    max, for the plain chain and the unsplit walk as much as for the
    split one. So the tier's ops here take el and er with the fused
    tier's roundings, the gradient flowing through them in f32 as through
    the fused tier's VJP."""
    src, dst, n = hub_walks.hub_split_arrays(9, n=2048, n_random=2000)
    gt = build_graph(src, dst, n)
    gj = jax_build_graph(src, dst, n).with_plans()
    assert gj.smx is None

    def xla_tier(f, a, b):
        el = jnp.sum(_bf16_forward(f) * _bf16_forward(a)[None], -1)
        er = _bf16_forward(jnp.sum(f * b[None], -1))
        e = jax_refops.u_add_v(gj, el, er)
        e = jnp.where(e >= 0, e, 0.2 * e)
        return jax_refops.u_mul_e_sum(gj, f, jax_refops.edge_softmax(gj, e))

    rs = np.random.RandomState(14)
    feat = rs.randn(n, 2, 8).astype(np.float32)
    al, ar = ((rs.randn(2, 8) * logit).astype(np.float32) for _ in range(2))
    _patch_split_walks(monkeypatch)
    _layer_grads(gt, xla_tier, feat, al, ar)


@pytest.mark.parametrize("heads", [1, 3, 8, 40])
def test_softmax_split_walk_matches_plain(heads):
    """edge_softmax_fwd with rows of more than T edges split (chunk maxima,
    chunk sums with the row's max, alpha per chunk) on rows of 0 to 20 T
    edges: against the plain version (sums in f64) and the unsplit walk at
    rtol 1e-5 / atol 1e-6; rows of at most T edges are the unsplit walk's
    bit for bit."""
    src, dst, n = hub_walks.hub_split_arrays(heads + 30)
    g = build_graph(src, dst, n)
    s = torch.from_numpy(3 * np.random.RandomState(heads).randn(
        g.n_edges, heads).astype(np.float32))
    got = hub_walks.softmax_fwd_walk(g.indptr, s, n, HT)
    whole = hub_walks.softmax_fwd_walk(g.indptr, s, n, 10 ** 9)
    want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, n)
    for other in (want, whole):
        torch.testing.assert_close(got, other, rtol=1e-5, atol=1e-6)
    deg = torch.from_numpy(np.diff(g.indptr[:n + 1].numpy()))
    edge_short = (deg <= HT)[g.receivers.long()]
    assert torch.equal(got[edge_short], whole[edge_short])
    split = g.receivers.long() == len(HUB_SPLIT) - 1
    torch.testing.assert_close(got[split].sum(0), torch.ones(heads))


@pytest.mark.parametrize("heads", [None, 1, 8])
def test_softmax_split_walk_matches_jax(heads):
    """The split walk against glnn_tpu's softmax on the same numpy scores:
    the interpret-mode gat_pallas.edge_softmax on rows of up to 2 T + 3
    edges (planned) at rtol 1e-5 / atol 1e-6, as tests/test_torch_gat.py
    holds the plain version, and refops.edge_softmax (the XLA tier) on
    rows of up to 20 T edges at rtol 2e-5: refops sums a row's 10,240
    exponentials in f32, 1.4e-5 of itself off the f64 sums of
    plain_edge_softmax_fwd on one [E, 8] element, where the walk stays
    within 1.2e-7 of them (test_softmax_split_walk_matches_plain)."""
    for degrees, seed, rtol in ((HUB_SPLIT, 3, 2e-5), (
            (0, 1, HT - 1, HT, HT + 1, 2 * HT + 3), 4, 1e-5)):
        src, dst, n = hub_walks.hub_split_arrays(seed, degrees, n=2048,
                                                 n_random=2000)
        g = build_graph(src, dst, n)
        gj = jax_build_graph(src, dst, n)
        shape = (g.n_edges,) if heads is None else (g.n_edges, heads)
        s = (3 * np.random.RandomState(seed).randn(*shape)).astype(
            np.float32)
        got = hub_walks.softmax_fwd_walk(
            g.indptr, torch.from_numpy(s).reshape(g.n_edges, -1), n, HT)
        got = got.reshape(shape).numpy()
        if degrees is HUB_SPLIT:
            want = jax_refops.edge_softmax(gj, jnp.asarray(s))
        else:
            gj = gj.with_plans()
            assert gj.smx is not None
            want = gat_pallas.edge_softmax(gj, jnp.asarray(s))
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=1e-6)


def _softmax_bwd_case(seed, heads, degrees=HUB_SPLIT, **kw):
    """(g, alpha, dalpha) on the hub-split graph: alpha the plain softmax
    of scores 3 randn [E, H], dalpha randn."""
    src, dst, n = hub_walks.hub_split_arrays(seed, degrees, **kw)
    g = build_graph(src, dst, n)
    rs = np.random.RandomState(seed)
    s = torch.from_numpy(3 * rs.randn(g.n_edges, heads).astype(np.float32))
    da = torch.from_numpy(rs.randn(g.n_edges, heads).astype(np.float32))
    return g, gat_cuda.plain_edge_softmax_fwd(g.indptr, s, n), da


@pytest.mark.parametrize("heads", [1, 3, 8, 40])
def test_softmax_bwd_split_walk_matches_plain(heads):
    """edge_softmax_bwd with rows of more than T edges split (each chunk's
    part of t, t summed in chunk order by every chunk, ds per edge) on
    rows of 0 to 20 T edges: against plain_edge_softmax_bwd (sums in f64)
    and the unsplit walk at rtol 1e-5 / atol 1e-6; rows of at most T edges
    are the unsplit walk's bit for bit. ds sums to t (1 - sum alpha),
    about 0, over every row."""
    g, alpha, da = _softmax_bwd_case(heads + 50, heads)
    n = g.n_nodes
    got = hub_walks.softmax_bwd_walk(g.indptr, alpha, da, n, HT)
    whole = hub_walks.softmax_bwd_walk(g.indptr, alpha, da, n, 10 ** 9)
    want = gat_cuda.plain_edge_softmax_bwd(g.indptr, alpha, da, n)
    for other in (want, whole):
        torch.testing.assert_close(got, other, rtol=1e-5, atol=1e-6)
    deg = torch.from_numpy(np.diff(g.indptr[:n + 1].numpy()))
    edge_short = (deg <= HT)[g.receivers.long()]
    assert torch.equal(got[edge_short], whole[edge_short])
    assert not torch.equal(got[~edge_short], whole[~edge_short])
    split = g.receivers.long() == len(HUB_SPLIT) - 1
    assert got[split].abs().max() > 0
    torch.testing.assert_close(got[split].sum(0), torch.zeros(heads),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("heads", [None, 1, 8])
def test_softmax_bwd_split_walk_matches_jax(heads):
    """The split walk against glnn_tpu's softmax gradient, fed the alpha
    of glnn_tpu's forward and the same numpy dalpha: jax.vjp of the
    interpret-mode gat_pallas.edge_softmax (its _smx_bwd_kernel) on rows
    of up to 2 T + 3 edges (planned), and of refops.edge_softmax (the XLA
    tier, whose gradient autodiff forms as dalpha / sum - sum(dalpha exp)
    / sum^2, f32 row sums) on rows of up to 20 T edges, both at the
    softmax gradient's tolerance (rtol 1e-4 / atol 1e-6, as
    tests/test_torch_gat.py holds the plain version). The XLA tier's f32
    sums over the 10,240-edge row put its [E, 8] gradient 2.3e-6 from the
    f64 sums of plain_edge_softmax_bwd where the walk stays within 4.8e-7
    of them (an alpha of up to 0.29 on that row): the worst element lies at
    0.35 of the tolerance."""
    for degrees, seed in ((HUB_SPLIT, 5), (
            (0, 1, HT - 1, HT, HT + 1, 2 * HT + 3), 6)):
        src, dst, n = hub_walks.hub_split_arrays(seed, degrees, n=2048,
                                                 n_random=2000)
        g = build_graph(src, dst, n)
        gj = jax_build_graph(src, dst, n)
        shape = (g.n_edges,) if heads is None else (g.n_edges, heads)
        rs = np.random.RandomState(seed)
        s = (3 * rs.randn(*shape)).astype(np.float32)
        da = rs.randn(*shape).astype(np.float32)
        if degrees is HUB_SPLIT:
            alpha, vjp = jax.vjp(lambda x: jax_refops.edge_softmax(gj, x),
                                 jnp.asarray(s))
        else:
            gp = gj.with_plans()
            assert gp.smx is not None
            alpha, vjp = jax.vjp(lambda x: gat_pallas.edge_softmax(gp, x),
                                 jnp.asarray(s))
        (want,) = vjp(jnp.asarray(da))
        got = hub_walks.softmax_bwd_walk(
            g.indptr, torch.from_numpy(np.array(alpha)).reshape(
                g.n_edges, -1), torch.from_numpy(da).reshape(g.n_edges, -1),
            n, HT)
        np.testing.assert_allclose(got.reshape(shape).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-6)


def test_gat_bwd_and_softmax_take_the_kept_plan(monkeypatch):
    """The layer's backward hands gat_bwd the very plan its forward took
    (the dst-sorted CSR's kept plan at T = GAT_CHUNK), and edge_softmax and
    the halo softmax hand the softmax's forward and its backward their
    CSR's kept plan (T = HUB_CHUNK): over two layer steps and two softmax
    steps on the Graph, and two softmax steps on a halo shard, three plans
    are built for the Graph (the dst-sorted CSR at both T, and its
    transpose for the source reduce) and one for the shard's combined
    CSR."""
    from glnn_tpu_torch.distributed.halo import (build_halo_graph,
                                                 halo_edge_softmax)

    src, dst, n = hub_walks.hub_split_arrays(17)
    g = build_graph(src, dst, n)
    hg = build_halo_graph(src, dst, n, 1, combined=True)[0]
    taken = []
    fwd, bwd = gat_cuda.gat_fwd, gat_cuda.gat_bwd
    smx, smx_bwd = gat_cuda.edge_softmax_fwd, gat_cuda.edge_softmax_bwd
    monkeypatch.setattr(gat_cuda, "gat_fwd", lambda *a, **k: (
        taken.append(("gat_fwd", k["plan"])), fwd(*a, **k))[1])
    monkeypatch.setattr(gat_cuda, "gat_bwd", lambda *a, **k: (
        taken.append(("gat_bwd", k["plan"])), bwd(*a, **k))[1])
    monkeypatch.setattr(gat_cuda, "edge_softmax_fwd", lambda *a: (
        taken.append(("softmax", a[3])), smx(*a))[1])
    monkeypatch.setattr(gat_cuda, "edge_softmax_bwd", lambda *a: (
        taken.append(("softmax_bwd", a[4])), smx_bwd(*a))[1])
    rs = np.random.RandomState(2)
    feat = torch.from_numpy(rs.randn(n, 2, 4).astype(np.float32))
    al, ar = (torch.from_numpy(rs.randn(2, 4).astype(np.float32))
              for _ in range(2))
    s = torch.from_numpy(rs.randn(g.n_edges, 3).astype(np.float32))
    spmm_cuda.builds["hub_plan"] = 0
    for _ in range(2):
        gat_cuda.gat_attention(g, feat.requires_grad_(True), al, ar).sum()\
            .backward()
        gat_cuda.edge_softmax(g, s.requires_grad_(True)).sum().backward()
    assert spmm_cuda.builds["hub_plan"] == 3
    plan = spmm_cuda.plan_of(g, "indptr", n)
    gat_plan = spmm_cuda.plan_of(g, "indptr", n, gat_cuda.GAT_CHUNK)
    assert spmm_cuda.builds["hub_plan"] == 3
    assert plan.n_chunks > 0 and gat_plan.n_chunks > plan.n_chunks
    assert [name for name, _ in taken] == ["gat_fwd", "gat_bwd", "softmax",
                                           "softmax_bwd"] * 2
    assert all(p is (gat_plan if name.startswith("gat") else plan)
               for name, p in taken)
    taken.clear()
    for _ in range(2):
        halo_edge_softmax(hg, s[:hg.n_edges], kernel=True).sum().backward()
    assert spmm_cuda.builds["hub_plan"] == 4
    halo_plan = spmm_cuda.plan_of(hg, "c_indptr", hg.rows)
    assert [name for name, _ in taken] == ["softmax", "softmax_bwd"] * 2
    assert all(p is halo_plan for _, p in taken)
    assert spmm_cuda.builds["hub_plan"] == 4


# ---- the GAT attention forward ---------------------------------------------

def _keep_words(keep, h0, hp):
    """Per edge, the word the chunk lane packs: bit i for head h0 + i."""
    n_edges, heads = keep.shape
    words = torch.zeros(n_edges, dtype=torch.int64)
    for i in range(min(hp, heads - h0)):
        words |= keep[:, h0 + i].long() << i
    return words


def _gat_fwd_mirror(indptr, senders, feat_b, el, er_b, keep, inv_keep,
                    slope):
    """csrc/gat_csr.cu's gat_fwd in f32 torch on the CPU, one row and head
    pass at a time: (out, max, denom)."""
    n_rows, heads = er_b.shape
    geo = gat_cuda.fwd_geometry(heads, feat_b.shape[2])
    slots, hp = geo.slots, geo.hp
    if keep is None:
        inv_keep = 1.0    # without dropout every weight is 1
    elif keep.dtype == torch.int64:
        keep = gat_cuda.philox_keep(keep, senders.numel(), heads,
                                    1.0 / inv_keep)
    out = torch.zeros((n_rows,) + tuple(feat_b.shape[1:]))
    smax = torch.zeros((n_rows, heads))
    denom = torch.zeros((n_rows, heads))
    for h0 in range(0, heads, hp):
        hs = slice(h0, min(h0 + hp, heads))
        words = (_keep_words(keep, h0, hp) if keep is not None
                 else torch.full((senders.numel(),), (1 << 32) - 1))
        bit = torch.arange(hs.stop - h0)
        for v in range(n_rows):
            a, b = int(indptr[v]), int(indptr[v + 1])
            if a == b:
                continue
            src = senders[a:b].long()
            s = el[src, hs] + er_b[v, hs].float()
            s = torch.where(s >= 0, s, slope * s)                  # [e, hp]
            m = s.max(0).values                  # the lanes' maxima, folded
            p = torch.exp(s - m)                 # lane j: edge e0 + j
            kept = (words[a:b, None] >> bit) & 1 == 1
            pw = torch.where(kept, p * inv_keep, torch.zeros_like(p))
            den = torch.zeros((slots, hs.stop - h0))
            acc = torch.zeros((slots, hs.stop - h0, feat_b.shape[2]))
            for e0 in range(0, b - a, 32):
                n = min(32, b - a - e0)
                for j in range(-(-n // slots)):
                    for q in range(min(slots, n - j * slots)):
                        k = e0 + j * slots + q
                        den[q] += p[k]
                        acc[q] += pw[k, :, None] * feat_b[src[k], hs].float()
            den = _fold(den)
            out[v, hs] = _fold(acc) * (1.0 / den)[:, None]
            smax[v, hs], denom[v, hs] = m, den
    return out, smax, denom


@pytest.mark.parametrize("drop", ["none", "seed"])
@pytest.mark.parametrize("h,d", [(8, 16), (1, 40), (3, 5), (12, 4)])
def test_gat_fwd_mirror_matches_plain(h, d, drop):
    """Rows of 0, 1, 31-33, 64, 65, 150 and 200 edges, logits of about
    randn x 10 (concentrated attention); seed mode generates the mask from
    a seed as the kernels do."""
    g = build_graph(*_graph_arrays(h * d, (1, 31, 32, 33, 64, 65, 150, 200)),
                    N)
    rs = np.random.RandomState(d)
    feat = torch.from_numpy(rs.randn(N, h, d).astype(np.float32))
    al, ar = (torch.from_numpy((rs.randn(h, d) * 10 / np.sqrt(d))
                               .astype(np.float32)) for _ in range(2))
    feat_b, el, er_b, _ = gat_cuda.prep(feat, al, ar)
    keep = (torch.tensor([987654321], dtype=torch.int64) if drop == "seed"
            else None)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep, 1 / 0.7, 0.2)
    got, want = _gat_fwd_mirror(*args), gat_cuda.plain_gat_fwd(*args)
    _close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    _close(got[2], want[2], rtol=1e-5, scale=1e-6)
    assert got[0][0].abs().max() == 0 and got[2][0].abs().max() == 0


# ---- the segment softmax forward -------------------------------------------

def _butterfly(parts):
    """The kernel's __shfl_xor_sync sum over slots (a power of two)."""
    parts = list(parts)
    off = 1
    while off < len(parts):
        parts = [parts[q] + parts[q ^ off] for q in range(len(parts))]
        off *= 2
    return parts[0]


def _softmax_fwd_mirror(indptr, scores, n_rows):
    """csrc/gat_csr.cu's edge_softmax_fwd in f32 on the CPU: (alpha, reads
    of each score, rows walked by the whole warp)."""
    n_edges, heads = scores.shape
    g, p, r = gat_cuda.softmax_geometry(heads, n_edges, n_rows)
    alpha = torch.zeros_like(scores)
    reads = torch.zeros(scores.shape, dtype=torch.int64)
    long_rows = []
    for v in range(n_rows):
        a, b = int(indptr[v]), int(indptr[v + 1])
        if b - a > p * r:
            long_rows.append(v)
            continue
        if a == b:
            continue
        reads[a:b] += 1
        vals = [scores[a + q:b:p] for q in range(p)]       # slot q's edges
        m = torch.stack([x.max(0).values if len(x) else
                         torch.full((heads,), -np.inf) for x in vals]).max(0)
        ex = [torch.exp(x - m.values) for x in vals]
        den = _butterfly([x.sum(0) for x in ex])
        for q in range(p):
            alpha[a + q:b:p] = ex[q] / den
    per = 32 // g
    for v in long_rows:
        a, b = int(indptr[v]), int(indptr[v + 1])
        reads[a:b] += 3               # max, sum and write passes
        m = scores[a:b].max(0).values
        parts = []
        for q in range(per):
            den = torch.zeros(heads)
            comp = torch.zeros(heads)
            for e in range(a + q, b, per):
                y = torch.exp(scores[e] - m) - comp
                t = den + y
                comp = (t - den) - y
                den = t
            parts.append(den - comp)
        alpha[a:b] = torch.exp(scores[a:b] - m) / _butterfly(parts)
    return alpha, reads, long_rows


@pytest.mark.parametrize("heads", [1, 3, 8, 40])
def test_softmax_fwd_mirror_matches_plain(heads):
    """Rows of 0-200 edges and one of 2,000 (mean in-degree about 10, so a
    row of up to 32 edges is read once); the plain version at rtol 1e-5."""
    g = build_graph(*_graph_arrays(heads, (1, 31, 32, 33, 64, 65, 200, 2000),
                                   n=4000, n_random=40000), 4000)
    s = torch.from_numpy(3 * np.random.RandomState(heads).randn(
        g.n_edges, heads).astype(np.float32))
    got, reads, long_rows = _softmax_fwd_mirror(g.indptr, s, g.n_nodes)
    want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, g.n_nodes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    deg = g.in_degrees.long()
    geo = gat_cuda.softmax_geometry(heads, g.n_edges, g.n_nodes)
    assert sorted(long_rows) == torch.nonzero(
        deg > geo.p * geo.r).flatten().tolist()
    short = ~torch.isin(g.receivers.long(), torch.tensor(long_rows))
    assert (reads[short] == 1).all()
