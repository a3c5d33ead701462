"""Mirrors of the CUDA kernels' walks with hub rows split across warps, for
the CPU tests (tests/test_torch_kernel_design.py) and the card's
(tests/test_torch_cuda.py). No JAX here: the card's tests import it.

* `template_walk` follows csrc/spmm_csr.cu in numpy: an item is a row of at
  most T edges or one T-edge chunk of a longer row (the hub plan's); its
  edges are taken a 32-edge window at a time, edge k of a window by edge
  group k % groups, each group summing its edges in order; the groups fold
  onto group 0; a split row's chunk partials are summed in chunk order
  from zero; the int8 policy sums exactly and scales once at the end. The
  weighted policy with one weight per edge first drops, within each
  window, the edges whose weight is 0 and numbers the kept ones in order:
  kept edge r goes to group r % groups. Its f32 adds are the kernel's, in
  the kernel's order, so on the card the kernel must equal it bit for
  bit.
* `gat_fwd_walk` follows gat_fwd in f32 torch: per item and pass of heads,
  lane j scores the 32-edge window's edge j; a row's max over its edges, a
  chunk's over its row's chunk maxima; each term exp(s - max) once; p and
  p w f summed per edge slot and folded onto slot 0; a row divides by its
  own den, a split row's den and p w f are the sums of its chunks' in
  chunk order. Its exponentials and products are torch's on the CPU, not
  the card's expf and fused multiply-adds, so it equals the kernel only to
  a tolerance.
* `gat_bwd_walk` follows gat_bwd in f32 torch, one item at a time: a
  chunk's part of t (alpha w g summed per edge slot, edge k of each 32-edge
  window in slot k % slots, the slots folded onto slot 0); a split row's t
  its chunks' parts summed in chunk order from zero, the same t for every
  chunk; ds_pre per edge with that t; der per item folded as t is, a
  split row's its chunks' in chunk order; the message per edge; dattn_l
  summed over every edge (the kernel's per-warp order depends on the
  grid). A tolerance again, for the same reason.
* `softmax_fwd_walk` follows edge_softmax_fwd in f32 torch: a row of at
  most P R edges in registers (per slot, the slots summed by a butterfly
  over slot ^ 1, ^ 2, ...); a longer row of at most T edges by the whole
  warp, a chunk of a longer row by one warp (lane slot q takes the edges
  q, q + 32 / G, ... of its range in order, a compensated sum each, the
  slots summed by a butterfly over slot ^ (32 / G) / 2, ..., ^ 1); a
  split row's max the max of its chunks', its den its chunks' sums in
  chunk order from zero.
* `softmax_bwd_walk` follows edge_softmax_bwd in f32 torch: per item (a
  row of at most T edges, or a chunk of a longer one) lane slot q sums
  alpha * dalpha over the edges q, q + 32 / G, ... of its range in order,
  each step one fused multiply-add (emulated in f64, where the product of
  two f32 values is exact), the slots summed by the butterfly as in
  `softmax_fwd_walk`; a split row's t its chunks' parts summed in chunk
  order from zero, the same t for every chunk; ds = alpha * dalpha -
  alpha * t per edge.
"""

import numpy as np
import torch

from glnn_tpu_torch.ops import gat_cuda, spmm_cuda

T = spmm_cuda.HUB_CHUNK
# the rows' degrees of the split tests: empty, one edge, either side of T,
# and 20 T
HUB_SPLIT = (0, 1, T - 1, T, T + 1, 20 * T)


def hub_split_arrays(seed, degrees=HUB_SPLIT, n=300, n_random=2500):
    """(src, dst, n): n_random random edges among rows len(degrees).. of n,
    and rows 0, 1, ... with degrees[i] in-edges and as many out-edges (so
    both walks meet them), to and from random other rows (repeats
    allowed)."""
    rs = np.random.RandomState(seed)
    k = len(degrees)
    hubs = np.repeat(np.arange(k), degrees)
    ends = [rs.randint(k, n, hubs.size) for _ in range(2)]
    src = np.concatenate([ends[0], hubs, rs.randint(k, n, n_random)])
    dst = np.concatenate([hubs, ends[1], rs.randint(k, n, n_random)])
    return src, dst, n


def fold(parts):
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


def items(indptr, n_rows, chunk):
    """(row, [(begin, end), ...]) per row: one range for a row of at most
    `chunk` edges, its T-edge chunks (the hub plan's) for a longer one."""
    for row in range(n_rows):
        a, b = int(indptr[row]), int(indptr[row + 1])
        if b - a <= chunk:
            yield row, [(a, b)]
        else:
            yield row, [(c, min(b, c + chunk)) for c in range(a, b, chunk)]


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest, ties to even) and back."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def window_ranks(keep: np.ndarray) -> np.ndarray:
    """Each edge's rank among the kept edges of its 32-edge window (the
    edges of an item in order; `keep` bool [n])."""
    kept = keep.astype(np.int64)
    before = np.cumsum(kept) - kept                 # kept edges before it
    start = np.arange(keep.shape[0]) // 32 * 32     # its window's first edge
    return before - np.concatenate([[0], np.cumsum(kept)])[start]


def _item_sum(terms: np.ndarray, groups: int, keep=None) -> np.ndarray:
    """One warp's walk of an item whose per-edge terms are `terms` [n, F]:
    the edges where `keep` (bool [n], all where None) numbered in order
    within each 32-edge window, kept edge r going to group r % groups, each
    group sums its edges in order (add.accumulate is sequential), the
    groups fold."""
    zero = np.zeros(terms.shape[1:], terms.dtype)
    if terms.shape[0] == 0:
        return zero
    if keep is None:
        keep = np.ones(terms.shape[0], bool)
    grp = window_ranks(keep) % groups
    parts = []
    for q in range(groups):
        mine = terms[keep & (grp == q)]
        parts.append(np.add.accumulate(mine, axis=0)[-1] if len(mine)
                     else zero)
    return fold(parts)


def template_walk(indptr, indices, x, n_rows, geo, chunk, policy="bf16",
                  scale=None, w=None, widx=None, heads=1, compact=True):
    """csrc/spmm_csr.cu's walk in numpy: out f32 [n_rows, F].

    policy "bf16": x holds bf16 values as f32, summed in f32; "int8": x
    int8 values, summed exactly, then acc * scale in f32; "weighted": x
    f32 [*, F], w f32 [E, heads], terms bf16(x[src] * w[widx(e), head])
    summed in f32 (widx(e) = widx[e], or e where widx is None; column c
    takes head c // (F // heads)); with heads 1 and `compact` the edges of
    weight 0 are dropped from each window before the groups take theirs
    (the kernel's walk; `compact` False walks every edge, the order the
    kernel took before it compacted). geo = (vec, lanes, groups) as
    spmm_cuda.geometry gives it; chunk = the plan's T."""
    _, _, groups = geo
    f = x.shape[1]
    indices = np.asarray(indices)
    if policy == "int8":
        x = np.asarray(x, np.int64)
    else:
        x = np.asarray(x, np.float32)
    if policy == "weighted":
        w = np.asarray(w, np.float32).reshape(-1, heads)
        head_of = np.arange(f) // (f // heads)

    def walk(a, b):
        """One item's sum over edges a:b."""
        rows = x[indices[a:b]]
        if policy != "weighted":
            return _item_sum(rows, groups)
        slots = np.arange(a, b) if widx is None else np.asarray(widx)[a:b]
        keep = w[slots, 0] != 0 if heads == 1 and compact else None
        return _item_sum(bf16_round(rows * w[slots][:, head_of]), groups,
                         keep)

    out = np.zeros((n_rows, f), np.float32)
    for row, ranges in items(indptr, n_rows, chunk):
        if len(ranges) == 1:
            acc = walk(*ranges[0])
        else:  # each chunk a warp's, then summed in chunk order from zero
            acc = np.zeros(f, np.int64 if policy == "int8" else np.float32)
            for a, b in ranges:
                acc = acc + walk(a, b)
        out[row] = (acc.astype(np.float32) * np.asarray(scale, np.float32)
                    if policy == "int8" else acc)
    return out


def _keep_words(keep, h0, hp):
    """Per edge, the word its lane packs: bit i for head h0 + i."""
    words = torch.zeros(keep.shape[0], dtype=torch.int64)
    for i in range(min(hp, keep.shape[1] - h0)):
        words |= keep[:, h0 + i].long() << i
    return words


def gat_fwd_walk(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                 chunk):
    """gat_fwd in f32 torch on the CPU with rows of more than `chunk`
    edges split: (out, max, denom)."""
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

    def scores(a, b, hs):
        s = el[senders[a:b].long(), hs] + er_b[row, hs].float()
        return torch.where(s >= 0, s, slope * s)

    for h0 in range(0, heads, hp):
        hs = slice(h0, min(h0 + hp, heads))
        nh = hs.stop - h0
        words = (_keep_words(keep, h0, hp) if keep is not None
                 else torch.full((senders.numel(),), (1 << 32) - 1))
        bit = torch.arange(nh)
        for row, ranges in items(indptr, n_rows, chunk):
            a, b = ranges[0][0], ranges[-1][1]
            if a == b:
                continue
            # a max is exact in any order: a chunk's row max is its row's
            m = torch.stack([scores(c, d, hs).max(0).values
                             for c, d in ranges]).max(0).values
            den_sum = torch.zeros(nh)
            acc_sum = torch.zeros((nh, feat_b.shape[2]))
            for c, d in ranges:
                src = senders[c:d].long()
                p = torch.exp(scores(c, d, hs) - m)
                kept = (words[c:d, None] >> bit) & 1 == 1
                pw = torch.where(kept, p * inv_keep, torch.zeros_like(p))
                den = torch.zeros((slots, nh))
                acc = torch.zeros((slots, nh, feat_b.shape[2]))
                for e0 in range(0, d - c, 32):
                    n = min(32, d - c - e0)
                    for j in range(-(-n // slots)):
                        for q in range(min(slots, n - j * slots)):
                            k = e0 + j * slots + q
                            den[q] += p[k]
                            acc[q] += (pw[k, :, None]
                                       * feat_b[src[k], hs].float())
                den_sum = den_sum + fold(den)
                acc_sum = acc_sum + fold(acc)
            out[row, hs] = acc_sum * (1.0 / den_sum)[:, None]
            smax[row, hs], denom[row, hs] = m, den_sum
    return out, smax, denom


def gat_bwd_walk(indptr, senders, feat_b, el, er_b, keep, inv_keep, slope,
                 smax, denom, dout, al_b, chunk):
    """gat_bwd in f32 torch on the CPU with rows of more than `chunk` edges
    split: (der, msg bf16, dattn_l)."""
    n_rows, heads = er_b.shape
    slots = gat_cuda.bwd_geometry(heads, feat_b.shape[2]).slots
    if keep is None:
        inv_keep = 1.0    # without dropout every weight is 1
    elif keep.dtype == torch.int64:
        keep = gat_cuda.philox_keep(keep, senders.numel(), heads,
                                    1.0 / inv_keep)
    der = torch.zeros((n_rows, heads))
    msg = torch.zeros((senders.numel(),) + tuple(feat_b.shape[1:]))
    dal = torch.zeros(feat_b.shape[1:])
    al = al_b.float()
    dout = dout.float()

    def by_slot(values):
        """An item's per-slot sums, each in edge order, folded."""
        slot = (torch.arange(values.shape[0]) % 32) % slots
        return fold([values[slot == q].cumsum(0)[-1] if (slot == q).any()
                     else torch.zeros(values.shape[1:])
                     for q in range(slots)])

    def terms(a, b, v):
        src = senders[a:b].long()
        feat = feat_b[src].float()                              # [e, H, D]
        s_pre = el[src] + er_b[v].float()
        alpha = torch.exp(torch.where(s_pre >= 0, s_pre, slope * s_pre)
                          - smax[v]) * (1.0 / denom[v])
        w = (keep[a:b].float() * inv_keep if keep is not None
             else torch.ones_like(alpha))
        wg = w * (feat * dout[v]).sum(-1)
        lk = torch.where(s_pre >= 0, torch.ones_like(s_pre),
                         torch.full_like(s_pre, slope))
        return feat, alpha, w, wg, lk

    for v, ranges in items(indptr, n_rows, chunk):
        if ranges[0][0] == ranges[-1][1]:
            continue
        parts = [terms(a, b, v) for a, b in ranges]
        # the items' sums in chunk order from zero (0 + x is x: a row of
        # one item is its own sum)
        t = torch.zeros(heads)
        for _, alpha, _, wg, _ in parts:
            t = t + by_slot(alpha * wg)
        for (a, b), (feat, alpha, w, wg, lk) in zip(ranges, parts):
            ds_pre = lk * (alpha * (wg - t))
            der[v] += by_slot(ds_pre)
            dal += (ds_pre[..., None] * feat).sum(0)
            msg[a:b] = ((alpha * w)[..., None] * dout[v]
                        + ds_pre[..., None] * al)
    return der, msg.to(torch.bfloat16), dal


def _xor_sum(parts, offsets):
    """The lanes' __shfl_xor_sync sum over slots, slot ^ o for each o in
    `offsets` in turn; slot 0's result."""
    parts = list(parts)
    for off in offsets:
        parts = [parts[q] + parts[q ^ off] for q in range(len(parts))]
    return parts[0]


def _warp_den(ex, per):
    """One warp's compensated sums of ex [e, H] over its range: slot q
    takes edges q, q + per, ... in order; the slots' sums (less their lost
    parts) summed by the butterfly from per / 2 down to 1."""
    heads = ex.shape[1]
    parts = []
    for q in range(per):
        den, comp = torch.zeros(heads), torch.zeros(heads)
        for y0 in ex[q::per]:
            y = y0 - comp
            t = den + y
            comp = (t - den) - y
            den = t
        parts.append(den - comp)
    return _xor_sum(parts, _butterfly(per))


def _butterfly(per):
    """The butterfly's slot offsets over 32 / G = per slots: per / 2, ...,
    1."""
    offs, o = [], per // 2
    while o >= 1:
        offs.append(o)
        o //= 2
    return offs


def _warp_t(alpha, dalpha, per):
    """One warp's t of an item, alpha and dalpha [e, H]: slot q takes edges
    q, q + per, ... in order, t = fma(alpha, dalpha, t) each; the slots'
    sums by the butterfly."""
    e, heads = alpha.shape
    steps = -(-e // per)
    pad = alpha.new_zeros((steps * per - e, heads))
    a = torch.cat([alpha, pad]).double().view(steps, per, heads)
    da = torch.cat([dalpha, pad]).double().view(steps, per, heads)
    t = torch.zeros((per, heads))
    for j in range(steps):      # padding adds 0 * 0: t unchanged
        t = (t.double() + a[j] * da[j]).float()
    return _xor_sum(list(t), _butterfly(per))


def softmax_bwd_walk(indptr, alpha, dalpha, n_rows, chunk):
    """edge_softmax_bwd in f32 torch on the CPU with rows of more than
    `chunk` edges split: ds [E, H]."""
    heads = alpha.shape[1]
    per = 32 // gat_cuda.softmax_geometry(heads, 1, 1).g
    ds = torch.zeros_like(alpha)
    for _, ranges in items(indptr, n_rows, chunk):
        a, b = ranges[0][0], ranges[-1][1]
        if a == b:
            continue
        # the items' parts in chunk order from zero (0 + x is x: a row of
        # one item is its own t)
        t = torch.zeros(heads)
        for c, d in ranges:
            t = t + _warp_t(alpha[c:d], dalpha[c:d], per)
        ds[a:b] = alpha[a:b] * dalpha[a:b] - alpha[a:b] * t
    return ds


def softmax_fwd_walk(indptr, scores, n_rows, chunk):
    """edge_softmax_fwd in f32 torch on the CPU with rows of more than
    `chunk` edges split: alpha [E, H]."""
    n_edges, heads = scores.shape
    g, p, r = gat_cuda.softmax_geometry(heads, n_edges, n_rows)
    per = 32 // g
    alpha = torch.zeros_like(scores)
    offs = [1 << i for i in range(p.bit_length() - 1)]
    for v, ranges in items(indptr, n_rows, chunk):
        a, b = ranges[0][0], ranges[-1][1]
        if a == b:
            continue
        s = scores[a:b]
        m = s.max(0).values          # a max is exact in any order
        ex = torch.exp(s - m)
        if b - a <= p * r:           # registers: slot q holds q, q + p, ...
            den = _xor_sum([ex[q::p].cumsum(0)[-1] if len(ex[q::p])
                            else torch.zeros(heads) for q in range(p)],
                           offs)
        elif len(ranges) == 1:       # the whole warp
            den = _warp_den(ex, per)
        else:                        # the chunks' sums in chunk order
            den = torch.zeros(heads)
            for c, d in ranges:
                den = den + _warp_den(ex[c - a:d - a], per)
        alpha[a:b] = ex / den
    return alpha
