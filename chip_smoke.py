#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

    python3 chip_smoke.py        # from the repository root, on one CUDA GPU

Phases, each fatal on failure:
  1. build the CUDA kernels of every path from glnn_tpu_torch/csrc with
     nvcc for sm_90a (one nvcc per source, started together) and log each
     kernel's ptxas register and spill counts;
  2. hold each kernel against its plain PyTorch version on the card, on the
     synth-n169343-c40-f128-d7 graph at the paths' shapes:
     - SpMM at the SAGE, GCN and APPNP widths (F = 40, 64, 128, 256):
       exact tier rtol 1e-5 / atol 1e-4 (only the summation order
       differs), int8 tier bit for bit (int32 sums are exact), and the
       gradient through the autograd.Function (the exact kernel's
       transposed walk) against the plain version of the backward at rtol
       1e-5 / atol 1e-4;
     - GAT (H, D) = (8, 16) and (1, 40), with and without a dropout mask:
       f32 outputs (out, denom, der, dattn_l) at rtol 1e-4 / atol
       1e-4 x max|want| (summation order, and the forward's online softmax
       rescaling its running sums), the segment max exactly, and the bf16
       message within one bf16 ulp (rtol 2**-7, atol 1e-5 x max|want|: a
       last-bit f32 difference can round either way). All are inside the
       1e-2 x max bound that tests/test_pallas.py:489 puts on the Pallas
       gradients;
     - the GAT autograd layer at both shapes, keep mask on: one backward
       (both kernels, the SpMM source reduce over t_indptr/t_edges,
       der * attn_r, the dattn_r einsum) against the plain chain; feat
       gradient at 1e-2 x max|want| (one bf16 ulp of a message element
       moves its source's gradient), attn_l/attn_r gradients at rtol 1e-4
       / atol 1e-4 x max|want| (f32 sums);
     - the weighted SpMM, scalar at F = 40 with APPNP's {0, 2} weights and
       with uniform weights, per head at (8, 16) and (1, 40) with
       softmax-like weights: forward, and dX and dW through the
       autograd.Function, at rtol 1e-5 / atol 1e-4 x max|want| (the same
       bf16-rounded products, summed in another order);
     - the segment softmax on [E], [E, 8] and [E, 1] scores (randn x 3),
       forward at rtol 1e-5 and gradient at rtol 1e-4
       (tests/test_pallas.py:368,421), atol 1e-6 x max|want|;
     all of it twice: on the synth graph, and on a hub graph of the same N
     and E whose first rows have HUB_DEGREES in- and out-edges (0 to
     20,000: every kernel walks a row in 32-edge chunks, and the synth
     graph's largest in-degree is 29), at the same tolerances;
  3. the op-surface path: the per-op GAT layer at both GAT shapes with a
     keep mask, composed from the public ops on CUDA (u_add_v ->
     leaky_relu -> edge_softmax -> mask -> u_mul_e_sum), counts set to 0
     before and read after (per shape one edge_softmax_fwd, one
     edge_softmax_bwd, two spmm_csr_weighted, no plain call); forward and
     one backward against the same composition through the plain versions
     at 1e-2 x max|want| (a product rounded to a neighbouring bf16 value
     moves one message by one bf16 ulp), and the forward against the fused
     gat_cuda.gat_attention at rtol 2e-2 / atol 1e-2 x max
     (tests/test_pallas.py:451; the two round er differently);
  4. drive the paths through the port's CLIs on cuda:0 at the ogbn-arxiv
     split sizes (so an epoch has as many batches as on ogbn-arxiv), with
     the launch counts set to 0 just before each path and read just after:
     - a sampled-SAGE teacher at the ogbn-arxiv recipe, then an MLP student
       distilled from its out.npz; both SpMM kernels must have launched;
     - a full-batch GAT teacher at the published GAT row (2 layers, hidden
       128 = 8 heads x 16, dropout 0.6, attention dropout 0.3, weight decay
       0.01), then an MLP student; gat_fwd must launch exactly
       2 x (3 steps + 3 evals + 1 final eval) = 14 times, gat_bwd 2 x 3 = 6
       times, and the SpMM source reduce at least 6 times;
     - a full-batch GCN teacher at the published synth row (2 layers,
       hidden 64, dropout 0.5, weight decay 0.001; both layers aggregate
       after W, at F = 64 and 40), then an MLP student: spmm_csr_bf16
       exactly 2 x (3 + 3 + 1) = 14, spmm_csr_int8 2 x 3 = 6;
     - a full-batch APPNP teacher at the published synth row (MLP
       128 -> 128 -> 40, dropout 0.5, weight decay 0.01, then 10 hops,
       alpha 0.1, edge drop 0.5, all at F = 40), then an MLP student:
       spmm_csr_weighted exactly 10 x 3 x 2 = 60, spmm_csr_int8 10 x 3 =
       30, spmm_csr_bf16 10 (the final eval);
     every other kernel exactly 0 on the GCN and APPNP paths; no plain
     version may run on a CUDA tensor, and each out.npz must hold finite
     [169343, 40] log-probs;
  5. time each kernel and its plain version with CUDA events, and the
     library call where one computes the same function (torch.sparse.mm
     for the SpMM sums, torch.bmm of a sparse [H, N, N] for the per-head
     weighted sum, torch.sparse.softmax and its backward for the softmax;
     no single PyTorch call computes fused GAT attention or the int8
     tier's sum), and compute each kernel's bound; then time the SpMM
     kernels at F = 40 and gat_bwd at both GAT shapes on the hub graph,
     where one warp walks each hub row alone (in the rows' detail, outside
     their sums).
Prints the card's name and power limit and a `kernels` JSON line; the last
line is {"ok": true, "device": {...}}. Exits non-zero, with no result
line, when there is no CUDA device or the port is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DATASET = "synth-n169343-c40-f128-d7"
N_NODES, N_CLASSES = 169343, 40
TEACHER_EPOCHS = 3
STUDENT_EPOCHS = 3
# per-class train/val counts that give ogbn-arxiv's split sizes on the
# synth graph's 40 round-robin classes: 90,920 train (arxiv 90,941) and
# 29,800 valid (29,799); the rest, 48,623, is test (48,603)
LABELRATE_TRAIN, LABELRATE_VAL = 2273, 745
WIDTHS = (128, 256, 256)     # F of the three SAGE layers' aggregations
GAT_SHAPES = ((8, 16), (1, 40))   # (heads, per-head width) of the 2 layers
ATTN_DROP = 0.3              # the GAT row's attention dropout
GCN_WIDTHS = (64, 40)        # F of the two GCN layers' aggregations
APPNP_F, APPNP_HOPS, EDGE_DROP = 40, 10, 0.5
# in-degrees (and out-degrees) of the hub graph's first rows: empty, one
# edge, either side of one and two 32-edge chunks, and two long rows
HUB_DEGREES = (0, 1, 31, 32, 33, 64, 65, 1000, 20000)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 peak rate
FP32_OPS_PER_S = 67e12       # H100 SXM, outside the tensor cores
SOURCES = {"spmm_csr_bf16": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "spmm_csr_int8": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "spmm_csr_weighted": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "gat_fwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "gat_bwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "edge_softmax_fwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "edge_softmax_bwd": "glnn_tpu_torch/csrc/gat_csr.cu"}
REPLACES = {
    "spmm_csr_bf16": "glnn_tpu/ops/spmm_pallas.py:93 (_block_kernel) and "
                     "glnn_tpu/ops/spmm_pallas.py:59 (_kernel)",
    "gat_fwd": "glnn_tpu/ops/gat_pallas.py:158 (_gat_fwd_kernel)",
    "gat_bwd": "glnn_tpu/ops/gat_pallas.py:187 (_gat_bwd_kernel)",
    "edge_softmax_fwd": "glnn_tpu/ops/gat_pallas.py:694 (_smx_fwd_kernel)",
    "edge_softmax_bwd": "glnn_tpu/ops/gat_pallas.py:712 (_smx_bwd_kernel)",
}
REPLACES["spmm_csr_int8"] = REPLACES["spmm_csr_bf16"]
REPLACES["spmm_csr_weighted"] = (REPLACES["spmm_csr_bf16"] + ", weighted "
                                 "(u_mul_e_sum, glnn_tpu/ops/spmm_pallas.py:438)")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build(cuda_build) -> None:
    t0 = time.perf_counter()
    messages = cuda_build.build(force=True)
    log(f"build: nvcc {' '.join(cuda_build.NVCC_FLAGS)}, one per source, "
        f"{sorted(cuda_build.SOURCES.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in sorted(messages.items()):
        for line in text.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")


def hub_graph(n, e, seed):
    """A graph of n nodes and e edges whose node i < len(HUB_DEGREES) has
    exactly HUB_DEGREES[i] in-edges and as many out-edges, from and to
    distinct other nodes, so that both the forward and the transposed walks
    meet those rows; the other edges join the remaining nodes uniformly
    (numpy, from `seed`)."""
    from glnn_tpu_torch.graph.container import build_graph

    rs = np.random.RandomState(seed)
    k = len(HUB_DEGREES)
    hubs = np.repeat(np.arange(k), HUB_DEGREES)
    rest = e - 2 * hubs.size
    # each hub's neighbours are distinct, as in a graph without multi-edges
    ends = [np.concatenate([rs.choice(np.arange(k, n), d, replace=False)
                            for d in HUB_DEGREES]) for _ in range(2)]
    src = np.concatenate([ends[0], hubs, rs.randint(k, n, rest)])
    dst = np.concatenate([hubs, ends[1], rs.randint(k, n, rest)])
    return build_graph(src, dst, n)


def phase_check(spmm_cuda, g) -> dict:
    """SpMM kernels vs plain versions on the card; max |error| per kernel."""
    gen = torch.Generator(device=g.device).manual_seed(0)
    n = g.n_nodes
    errs = {name: 0.0 for name in spmm_cuda.KERNELS}
    for f in sorted(set(WIDTHS + GCN_WIDTHS)):
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        got = spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n)
        want = spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        err = (got - want).abs().max().item()
        errs["spmm_csr_bf16"] = max(errs["spmm_csr_bf16"], err)
        log(f"check F={f}: exact kernel vs plain max|err| {err:.3e}")

        q, s = spmm_cuda.quantize_cols(x)
        got = spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n)
        want = spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s, n)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"int8 kernel differs from plain at F={f}: "
                                 f"{err}")
        errs["spmm_csr_int8"] = max(errs["spmm_csr_int8"], err)
        log(f"check F={f}: int8 kernel vs plain bit-equal, max|err| {err}")

        dh = torch.randn((n, f), generator=gen, device=g.device)
        want = spmm_cuda.plain_csr_sum_bf16(
            g.t_indptr, g.t_receivers, spmm_cuda.to_message(dh), n)
        for tier, op in (("exact", spmm_cuda.copy_u_sum),
                         ("int8", spmm_cuda.copy_u_sum_int8)):
            xg = x.clone().requires_grad_(True)
            (got,) = torch.autograd.grad(op(g, xg), xg, dh)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            err = (got - want).abs().max().item()
            errs["spmm_csr_bf16"] = max(errs["spmm_csr_bf16"], err)
            log(f"check F={f}: {tier} tier gradient vs plain max|err| "
                f"{err:.3e}")
    return errs


def gat_inputs(gat_cuda, g, h, d, drop, seed):
    """The kernels' inputs at one layer's shape: prep of random features
    and attention vectors, a keep mask when drop > 0, and a cotangent."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, dev = g.n_nodes, g.device
    feat = torch.randn((n, h, d), generator=gen, device=dev)
    al = 0.3 * torch.randn((h, d), generator=gen, device=dev)
    ar = 0.3 * torch.randn((h, d), generator=gen, device=dev)
    keep = (torch.rand((g.n_edges, h), generator=gen, device=dev) >= drop
            if drop else None)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    dout = torch.randn((n, h, d), generator=gen, device=dev)
    args = (g.indptr, g.senders, feat_b, el, er_b, keep,
            1.0 / (1.0 - drop), 0.2)
    return args, dout, al_b


def _held(name, got, want, rtol, scale) -> float:
    want = want.float()
    torch.testing.assert_close(
        got.float(), want, rtol=rtol,
        atol=scale * want.abs().max().item() + 1e-12,
        msg=lambda detail: f"{name}: {detail}")
    return (got.float() - want).abs().max().item()


def phase_check_gat(gat_cuda, g) -> dict:
    """GAT kernels vs plain versions on the card; max |error| per kernel."""
    errs = {name: 0.0 for name in gat_cuda.KERNELS}
    for h, d in GAT_SHAPES:
        for drop in (0.0, ATTN_DROP):
            args, dout, al_b = gat_inputs(gat_cuda, g, h, d, drop, h + d)
            out, smax, denom = gat_cuda.gat_fwd(*args)
            w_out, w_max, w_den = gat_cuda.plain_gat_fwd(*args)
            got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b)
            want = gat_cuda.plain_gat_bwd(*args, w_max, w_den, dout, al_b)
            torch.cuda.synchronize()
            if not torch.equal(smax, w_max):
                raise AssertionError(f"gat_fwd segment max differs at "
                                     f"(H, D) = ({h}, {d})")
            e_fwd = {"out": _held("out", out, w_out, 1e-4, 1e-4),
                     "denom": _held("denom", denom, w_den, 1e-4, 1e-4)}
            e_bwd = {"der": _held("der", got[0], want[0], 1e-4, 1e-4),
                     "msg": _held("msg", got[1], want[1], 2.0 ** -7, 1e-5),
                     "dattn_l": _held("dattn_l", got[2], want[2], 1e-4, 1e-4)}
            errs["gat_fwd"] = max(errs["gat_fwd"], *e_fwd.values())
            errs["gat_bwd"] = max(errs["gat_bwd"], *e_bwd.values())
            tag = f"(H, D) = ({h}, {d}), dropout {drop}"
            log(f"check {tag}: gat_fwd vs plain max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in e_fwd.items()) + ", max exact")
            log(f"check {tag}: gat_bwd vs plain max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in e_bwd.items()))
            del out, got, want, w_out
    return errs


def phase_check_gat_layer(gat_cuda, g) -> None:
    """One backward of the autograd layer (gat_fwd, gat_bwd, the SpMM source
    reduce over t_indptr/t_edges, der * attn_r, the dattn_r einsum) at each
    path shape, keep mask on, against the plain chain: plain_gat_fwd,
    plain_gat_bwd, the message summed over senders with index_add_."""
    n, dev = g.n_nodes, g.device
    inv_keep = 1.0 / (1.0 - ATTN_DROP)
    for h, d in GAT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(100 + h * d)
        feat = torch.randn((n, h, d), generator=gen, device=dev)
        al = 0.3 * torch.randn((h, d), generator=gen, device=dev)
        ar = 0.3 * torch.randn((h, d), generator=gen, device=dev)
        keep = torch.rand((g.n_edges, h), generator=gen, device=dev) >= ATTN_DROP
        dout = torch.randn((n, h, d), generator=gen, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        gat_cuda.gat_attention(g, *leaves, 0.2, keep, inv_keep).backward(dout)

        feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
        args = (g.indptr, g.senders, feat_b, el, er_b, keep, inv_keep, 0.2)
        _, smax, denom = gat_cuda.plain_gat_fwd(*args)
        der, msg, dal = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
        dfeat = torch.zeros_like(feat).index_add_(0, g.senders, msg.float())
        dfeat += der[:, :, None] * ar[None]
        dar = torch.einsum("nh,nhd->hd", der, feat)
        torch.cuda.synchronize()
        # dfeat at 1e-2 x max (the bound of tests/test_pallas.py:489): a
        # message element that the kernel and the plain version round to
        # neighbouring bf16 values moves its source's gradient by one bf16
        # ulp of that element; the f32 sums dattn_l and dattn_r at 1e-4
        errs = {"dfeat": _held("dfeat", leaves[0].grad, dfeat, 1e-2, 1e-2),
                "dattn_l": _held("dattn_l", leaves[1].grad, dal, 1e-4, 1e-4),
                "dattn_r": _held("dattn_r", leaves[2].grad, dar, 1e-4, 1e-4)}
        log(f"check (H, D) = ({h}, {d}), dropout {ATTN_DROP}: autograd layer "
            f"gradients vs plain chain max|err| " + ", ".join(
                f"{k} {v:.3e} (max|want| {w.abs().max().item():.3e})"
                for (k, v), w in zip(errs.items(), (dfeat, dal, dar))))
        del leaves, dfeat, msg, der


def weighted_cases(g, seed):
    """(tag, x, w) at the paths' shapes: scalar F = 40 with APPNP's {0, 2}
    keep weights and with uniform weights; per head at the GAT shapes with
    softmax-like weights (positive, summing to 1 over each dst's
    in-edges)."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, e, dev = g.n_nodes, g.n_edges, g.device
    x = torch.randn((n, APPNP_F), generator=gen, device=dev)
    keep = torch.rand(e, generator=gen, device=dev) >= EDGE_DROP
    cases = [(f"F={APPNP_F}, keep weights {{0, 2}}", x,
              keep.float() / (1.0 - EDGE_DROP)),
             (f"F={APPNP_F}, uniform weights", x,
              torch.rand(e, generator=gen, device=dev))]
    dst = g.receivers.long()
    for h, d in GAT_SHAPES:
        w = torch.rand((e, h), generator=gen, device=dev)
        w = w / torch.zeros((n, h), device=dev).index_add_(0, dst, w)[dst]
        cases.append((f"(H, D) = ({h}, {d}), softmax-like weights",
                      torch.randn((n, h, d), generator=gen, device=dev), w))
    return cases


def phase_check_weighted(spmm_cuda, g) -> float:
    """The weighted SpMM vs its plain version on the card: forward, and dX
    (the kernel over t_indptr/t_receivers with the weights read through
    t_edges) and dW (plain f32 torch) through the autograd.Function."""
    n = g.n_nodes
    src, dst = g.senders.long(), g.receivers.long()
    err = 0.0
    for tag, x, w in weighted_cases(g, 3):
        x2 = x.reshape(n, -1)
        got = spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, x2, w, n)
        want = spmm_cuda.plain_csr_wsum_bf16(g.indptr, g.senders, None, x2,
                                             w, n)
        e_fwd = _held("weighted forward", got, want, 1e-5, 1e-4)
        xg, wg = (t.clone().requires_grad_(True) for t in (x, w))
        dh = torch.randn_like(x)
        dx, dw = torch.autograd.grad(spmm_cuda.u_mul_e_sum(g, xg, wg),
                                     (xg, wg), dh)
        want_dx = spmm_cuda.plain_csr_wsum_bf16(
            g.t_indptr, g.t_receivers, g.t_edges, dh.reshape(n, -1), w, n)
        want_dw = (x[src] * dh[dst]).sum(-1)
        torch.cuda.synchronize()
        e_dx = _held("weighted dX", dx.reshape(n, -1), want_dx, 1e-5, 1e-4)
        e_dw = _held("weighted dW", dw, want_dw, 1e-5, 1e-4)
        err = max(err, e_fwd, e_dx, e_dw)
        log(f"check {tag}: spmm_csr_weighted vs plain max|err| forward "
            f"{e_fwd:.3e}, dX {e_dx:.3e}, dW {e_dw:.3e}")
        del got, want, dx, dw, want_dx, want_dw
    return err


def phase_check_softmax(gat_cuda, g) -> dict:
    """The segment softmax kernels vs their plain versions on the card, on
    [E], [E, 8] and [E, 1] scores, directly and through the
    autograd.Function."""
    gen = torch.Generator(device=g.device).manual_seed(4)
    n, e = g.n_nodes, g.n_edges
    errs = {"edge_softmax_fwd": 0.0, "edge_softmax_bwd": 0.0}
    for shape in ((e,), (e, 8), (e, 1)):
        s = 3.0 * torch.randn(shape, generator=gen, device=g.device)
        da = torch.randn(shape, generator=gen, device=g.device)
        sg = s.clone().requires_grad_(True)
        alpha = gat_cuda.edge_softmax(g, sg)
        (ds,) = torch.autograd.grad(alpha, sg, da)
        s2, da2 = s.reshape(e, -1), da.reshape(e, -1)
        got = gat_cuda.edge_softmax_fwd(g.indptr, s2, n)
        got_ds = gat_cuda.edge_softmax_bwd(g.indptr, got, da2, n)
        want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s2, n)
        want_ds = gat_cuda.plain_edge_softmax_bwd(g.indptr, want, da2, n)
        torch.cuda.synchronize()
        if alpha.shape != shape:
            raise AssertionError(f"edge_softmax gave {tuple(alpha.shape)} "
                                 f"for scores {shape}")
        e_fwd = max(_held("softmax", got, want, 1e-5, 1e-6),
                    _held("softmax op", alpha.reshape(e, -1), want, 1e-5,
                          1e-6))
        e_bwd = max(_held("softmax grad", got_ds, want_ds, 1e-4, 1e-6),
                    _held("softmax op grad", ds.reshape(e, -1), want_ds,
                          1e-4, 1e-6))
        errs["edge_softmax_fwd"] = max(errs["edge_softmax_fwd"], e_fwd)
        errs["edge_softmax_bwd"] = max(errs["edge_softmax_bwd"], e_bwd)
        log(f"check scores {list(shape)}: edge_softmax_fwd vs plain max|err| "
            f"{e_fwd:.3e}, edge_softmax_bwd {e_bwd:.3e}")
    return errs


class _PlainWSum(torch.autograd.Function):
    """u_mul_e_sum through the plain versions (the op-surface yardstick)."""

    @staticmethod
    def forward(ctx, x, w, g):
        from glnn_tpu_torch.ops import spmm_cuda

        ctx.save_for_backward(x, w)
        ctx.g = g
        n = g.n_nodes
        return spmm_cuda.plain_csr_wsum_bf16(
            g.indptr, g.senders, None, x.reshape(n, -1), w, n).view(x.shape)

    @staticmethod
    def backward(ctx, dh):
        from glnn_tpu_torch.ops import spmm_cuda

        x, w = ctx.saved_tensors
        g = ctx.g
        n = g.n_nodes
        dx = spmm_cuda.plain_csr_wsum_bf16(
            g.t_indptr, g.t_receivers, g.t_edges, dh.reshape(n, -1), w, n)
        dw = (x[g.senders.long()] * dh[g.receivers.long()]).sum(-1)
        return dx.view(x.shape), dw, None


class _PlainSoftmax(torch.autograd.Function):
    """edge_softmax through the plain versions (the op-surface yardstick)."""

    @staticmethod
    def forward(ctx, s, g):
        from glnn_tpu_torch.ops import gat_cuda

        alpha = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, g.n_nodes)
        ctx.save_for_backward(alpha)
        ctx.g = g
        return alpha

    @staticmethod
    def backward(ctx, da):
        from glnn_tpu_torch.ops import gat_cuda

        (alpha,) = ctx.saved_tensors
        return gat_cuda.plain_edge_softmax_bwd(
            ctx.g.indptr, alpha, da.contiguous(), ctx.g.n_nodes), None


def per_op_layer(ops, g, feat, al, ar, keep, softmax, wsum):
    """The GAT attention layer as JAX's dispatcher composes it from the
    per-op tiers (glnn_tpu/ops/__init__.py:210-221), with a keep mask."""
    el = (feat * al[None]).sum(-1)
    er = (feat * ar[None]).sum(-1)
    s = ops.u_add_v(g, el, er)
    s = torch.where(s >= 0, s, 0.2 * s)
    alpha = softmax(g, s) * keep.float() / (1.0 - ATTN_DROP)
    return wsum(g, feat, alpha)


def phase_op_surface(ops, cuda_build, spmm_cuda, gat_cuda, g) -> dict:
    """Drive the per-op GAT layer at both GAT shapes on CUDA, counts set to
    0 before and read after; then hold it against the plain composition
    and its forward against the fused kernel."""
    modules = (cuda_build, spmm_cuda, gat_cuda)
    n, e, dev = g.n_nodes, g.n_edges, g.device
    inputs = []
    for h, d in GAT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(200 + h * d)
        inputs.append((torch.randn((n, h, d), generator=gen, device=dev),
                       0.3 * torch.randn((h, d), generator=gen, device=dev),
                       0.3 * torch.randn((h, d), generator=gen, device=dev),
                       torch.rand((e, h), generator=gen, device=dev)
                       >= ATTN_DROP,
                       torch.randn((n, h, d), generator=gen, device=dev)))
    for module in modules:
        module.reset_counts()
    results = []
    for feat, al, ar, keep, dout in inputs:
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        out = per_op_layer(ops, g, *leaves, keep, ops.edge_softmax,
                           ops.u_mul_e_sum)
        out.backward(dout)
        results.append((out.detach(), [t.grad for t in leaves]))
    torch.cuda.synchronize()
    counts = {k: v for module in modules for k, v in module.counts.items()}
    layers = len(GAT_SHAPES)
    want = dict.fromkeys(counts, 0)
    want.update(edge_softmax_fwd=layers, edge_softmax_bwd=layers,
                spmm_csr_weighted=2 * layers)
    log(f"op-surface path: counts {counts}")
    if counts != want:
        raise AssertionError(f"op-surface path launched {counts}, expected "
                             f"{want}")

    for (feat, al, ar, keep, dout), (out, grads) in zip(inputs, results):
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        want_out = per_op_layer(
            ops, g, *leaves, keep, lambda g_, s: _PlainSoftmax.apply(s, g_),
            lambda g_, x, w: _PlainWSum.apply(x, w, g_))
        want_out.backward(dout)
        fused = gat_cuda.gat_attention(g, feat, al, ar, 0.2, keep,
                                       1.0 / (1.0 - ATTN_DROP))
        torch.cuda.synchronize()
        # 1e-2 x max: a product that the two round to neighbouring bf16
        # values moves one message, and its source's gradient, by one bf16
        # ulp of that element
        errs = {"out": _held("op-surface out", out, want_out, 1e-2, 1e-2)}
        for name, got, leaf in zip(("dfeat", "dattn_l", "dattn_r"), grads,
                                   leaves):
            errs[name] = _held(f"op-surface {name}", got, leaf.grad, 1e-2,
                               1e-2)
        errs["out vs fused"] = _held("op-surface vs fused", out, fused, 2e-2,
                                     1e-2)
        log(f"check (H, D) = {tuple(feat.shape[1:])}: op-surface layer vs "
            f"plain composition max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()))
        del leaves, want_out, fused
    return counts


def _config_yaml(path: str) -> None:
    """synth: the ogbn-arxiv SAGE and MLP rows, and the published GCN, GAT
    and APPNP synth rows (train.conf.yaml:82,85,86; ogbn-arxiv has none of
    them)."""
    import yaml

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "glnn_tpu_torch", "configs", "train.conf.yaml")
    with open(src) as f:
        table = yaml.safe_load(f)
    rows = {k: table["ogbn-arxiv"][k] for k in ("SAGE", "MLP")}
    rows.update({k: table["synth"][k] for k in ("GCN", "GAT", "APPNP")})
    with open(path, "w") as f:
        yaml.safe_dump({"defaults": table["defaults"], "synth": rows}, f)
    log(f"main path config: {rows}, defaults {table['defaults']}")


def drive_path(teacher: str, workdir: str, common: list, modules) -> dict:
    """Teacher then MLP student through the CLIs, the counts of `modules`
    set to 0 just before and read just after; checks the score line and
    out.npz."""
    from glnn_tpu_torch.cli import train_student, train_teacher

    student_out = io.StringIO()
    for module in modules:
        module.reset_counts()
    t0 = time.perf_counter()
    train_teacher.main(common + ["--teacher", teacher, "--max_epoch",
                                 str(TEACHER_EPOCHS)])
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(student_out):
        train_student.main(
            common + ["--teacher", teacher, "--student", "MLP", "--max_epoch",
                      str(STUDENT_EPOCHS), "--out_t_path",
                      os.path.join(workdir, "outputs")])
    t2 = time.perf_counter()
    counts = {k: v for module in modules for k, v in module.counts.items()}
    log(f"{teacher} path: teacher {t1 - t0:.2f} s ({TEACHER_EPOCHS} epochs), "
        f"student {t2 - t1:.2f} s ({STUDENT_EPOCHS} epochs); counts {counts}")
    for model in (teacher, f"{teacher}_MLP"):
        with open(os.path.join(workdir, "outputs", "transductive", DATASET,
                               model, "seed_0", "log")) as f:
            for line in f:
                if "mean epoch time" in line or "Best valid" in line:
                    log(f"  {model} log: {line.split(': ', 1)[1].strip()}")

    score = student_out.getvalue().strip()
    print(score)
    if not score or not all(math.isfinite(float(s)) for s in score.split()):
        raise AssertionError(f"student printed no score line: {score!r}")
    if counts["plain_on_cuda"]:
        raise AssertionError(f"{counts['plain_on_cuda']} plain-version calls "
                             f"on CUDA tensors on the {teacher} path")
    out_file = os.path.join(workdir, "outputs", "transductive", DATASET,
                            teacher, "seed_0", "out.npz")
    out = np.load(out_file)["arr_0"]
    lse = np.log(np.exp(out.astype(np.float64)).sum(axis=1))
    if out.shape != (N_NODES, N_CLASSES) or not np.isfinite(out).all():
        raise AssertionError(f"{teacher} out.npz: shape {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    if np.abs(lse).max() > 1e-4:
        raise AssertionError(f"{teacher} out.npz rows are not log-probs: max "
                             f"|logsumexp| {np.abs(lse).max()}")
    log(f"{teacher} out.npz: {out.shape} finite, max |logsumexp| "
        f"{np.abs(lse).max():.2e}")
    return counts


def phase_main_path(cuda_build, spmm_cuda, gat_cuda, workdir: str) -> dict:
    cfg = os.path.join(workdir, "arxiv.conf.yaml")
    _config_yaml(cfg)
    common = ["--device", "0", "--dataset", DATASET, "--eval_interval", "1",
              "--labelrate_train", str(LABELRATE_TRAIN),
              "--labelrate_val", str(LABELRATE_VAL),
              "--model_config_path", cfg, "--output_path",
              os.path.join(workdir, "outputs")]
    modules = (cuda_build, spmm_cuda, gat_cuda)
    sage = drive_path("SAGE", workdir, common, modules)
    for name in ("spmm_csr_bf16", "spmm_csr_int8"):
        if sage[name] == 0:
            raise AssertionError(f"{name} never launched on the SAGE path")
    gat = drive_path("GAT", workdir, common, modules)
    layers = len(GAT_SHAPES)
    want = {"gat_fwd": layers * (2 * TEACHER_EPOCHS + 1),
            "gat_bwd": layers * TEACHER_EPOCHS}
    for name, n in want.items():
        if gat[name] != n:
            raise AssertionError(f"{name} launched {gat[name]} times on the "
                                 f"GAT path, expected {n}")
    if gat["spmm_csr_bf16"] < want["gat_bwd"]:
        raise AssertionError(f"the GAT backward's source reduce launched "
                             f"{gat['spmm_csr_bf16']} times, expected at "
                             f"least {want['gat_bwd']}")
    # per path: eval-mode launches per epoch (int8 tier), training launches
    # per epoch (forward and backward), the final exact eval's launches
    expect = {
        "GCN": {"spmm_csr_bf16": len(GCN_WIDTHS) * (2 * TEACHER_EPOCHS + 1),
                "spmm_csr_int8": len(GCN_WIDTHS) * TEACHER_EPOCHS},
        "APPNP": {"spmm_csr_weighted": APPNP_HOPS * TEACHER_EPOCHS * 2,
                  "spmm_csr_int8": APPNP_HOPS * TEACHER_EPOCHS,
                  "spmm_csr_bf16": APPNP_HOPS},
    }
    paths = {"SAGE": sage, "GAT": gat}
    for teacher, launched in expect.items():
        got = drive_path(teacher, workdir, common, modules)
        want = dict.fromkeys(got, 0)
        want.update(launched)
        if got != want:
            raise AssertionError(f"the {teacher} path launched {got}, "
                                 f"expected {want}")
        paths[teacher] = got
    return paths


def _row(name, ms, plain_ms, nbytes, ops, library_ms, launches, errs,
         work, detail):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": sum(counts[name] for counts in launches.values()),
        "launches_by_path": {p: launches[p][name] for p in launches},
        "max_abs_err": errs[name], "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "work": work, **detail,
    }


def phase_times(spmm_cuda, g, launches: dict, errs: dict) -> list:
    """One all-node SAGE eval's three aggregations (F = 128, 256, 256) per
    unweighted SpMM kernel: kernel, plain version, library call, bound; the
    GCN widths (F = 64, 40) are timed too, per width, outside the sum, and
    the exact kernel's transposed walk (the GCN backward) at those widths."""
    gen = torch.Generator(device=g.device).manual_seed(1)
    n, e = g.n_nodes, g.n_edges
    # the library call wants sorted, distinct columns within each row; the
    # kernel takes the rows' edges in any order
    cols = torch.sort(g.receivers.long() * n + g.senders.long()).values % n
    adj = torch.sparse_csr_tensor(g.indptr[: n + 1], cols.to(torch.int32),
                                  torch.ones(e, device=g.device), (n, n),
                                  check_invariants=True)
    unweighted = ("spmm_csr_bf16", "spmm_csr_int8")
    rows = {name: dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, gather_bytes=0,
                       library_ms=0.0, per_width={})
            for name in unweighted}
    for i, f in enumerate(WIDTHS + GCN_WIDTHS):
        in_sum = i < len(WIDTHS)
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        q, s = spmm_cuda.quantize_cols(x)
        idx_bytes = 4 * (e + n + 1)
        cases = {
            "spmm_csr_bf16": (
                lambda: spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n),
                lambda: spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n),
                n * f * 2 + idx_bytes + n * f * 4, e * f * 2),
            "spmm_csr_int8": (
                lambda: spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n),
                lambda: spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s,
                                                     n),
                n * f + 4 * f + idx_bytes + n * f * 4, e * f),
        }
        # the library call gets the exact tier's bf16 values, held in f32
        lib_in = xb.float()
        torch.testing.assert_close(
            torch.sparse.mm(adj, lib_in),
            spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n),
            rtol=1e-5, atol=1e-4)
        lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_in))
        for name, (kernel, plain, nbytes, gbytes) in cases.items():
            k_ms, p_ms = time_ms(kernel), time_ms(plain)
            row = rows[name]
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            row["per_width"][f] = dict(ms=k_ms, plain_ms=p_ms,
                                       library_ms=lib_ms, bound_ms=bound)
            log(f"time F={f} {name}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, torch.sparse.mm f32 {lib_ms:.4f} ms, bytes "
                f"bound {bound:.4f} ms" + ("" if in_sum else " (GCN width)"))
            if not in_sum:
                continue
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bytes"] += nbytes
            row["gather_bytes"] += gbytes
            row["ops"] += e * f
            row["library_ms"] += lib_ms

    # the GCN backward: the exact kernel over the transposed CSR
    t_adj = _library_csr(g.t_indptr, g.t_receivers,
                         torch.ones(e, device=g.device), n)
    for f in GCN_WIDTHS:
        dh = spmm_cuda.to_message(
            torch.randn((n, f), generator=gen, device=g.device))
        kernel = lambda: spmm_cuda.csr_sum_bf16(g.t_indptr, g.t_receivers,  # noqa: E731,E501
                                                dh, n)
        lib_in = dh.float()
        torch.testing.assert_close(torch.sparse.mm(t_adj, lib_in), kernel(),
                                   rtol=1e-5, atol=1e-4)
        k_ms = time_ms(kernel)
        p_ms = time_ms(lambda: spmm_cuda.plain_csr_sum_bf16(
            g.t_indptr, g.t_receivers, dh, n))
        lib_ms = time_ms(lambda: torch.sparse.mm(t_adj, lib_in))
        bound = (n * f * 2 + 4 * (e + n + 1) + n * f * 4) / HBM_BYTES_PER_S * 1e3
        rows["spmm_csr_bf16"]["per_width"][f"{f} transposed"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound)
        log(f"time F={f} transposed walk spmm_csr_bf16: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, torch.sparse.mm f32 {lib_ms:.4f} ms, bytes "
            f"bound {bound:.4f} ms (GCN backward)")

    out = []
    for name in unweighted:
        row = rows[name]
        out.append(_row(
            name, row["ms"], row["plain_ms"], row["bytes"], row["ops"],
            # one PyTorch call for the exact tier's sum (f32 sums of the
            # bf16-rounded features); none computes the int8 tier's sum
            row["library_ms"] if name == "spmm_csr_bf16" else None,
            launches, errs,
            f"one all-node SAGE eval: F=128, 256, 256 over N={n}, E={e}",
            {"per_width_ms": row["per_width"]}))
        # every gathered row counted once per in-edge, over the HBM rate:
        # no bound, since x is partly served from L2
        log(f"{name}: E x F x itemsize of gathered rows over "
            f"{HBM_BYTES_PER_S:.3g} B/s would take "
            f"{row['gather_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return out


def phase_times_gat(gat_cuda, g, launches: dict, errs: dict) -> list:
    """One GAT training step's two layers, with the attention dropout mask,
    per kernel: kernel, plain version, bound. Bytes count each input read
    once and each output written once; operations count an exponential as
    one (forward about 2D + 6 per edge and head, backward 9D + 18)."""
    n, e = g.n_nodes, g.n_edges
    idx_bytes = 4 * (e + n + 1)
    rows = {name: dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, per_layer={})
            for name in ("gat_fwd", "gat_bwd")}
    for h, d in GAT_SHAPES:
        hd = h * d
        args, dout, al_b = gat_inputs(gat_cuda, g, h, d, ATTN_DROP, 7)
        _, smax, denom = gat_cuda.gat_fwd(*args)
        # indices, bf16 features, f32 el, bf16 er, the uint8 keep mask
        fwd_in = idx_bytes + n * hd * 2 + n * h * 4 + n * h * 2 + e * h
        cases = {
            "gat_fwd": (lambda: gat_cuda.gat_fwd(*args),
                        lambda: gat_cuda.plain_gat_fwd(*args),
                        fwd_in + n * hd * 4 + 2 * n * h * 4,
                        e * h * (2 * d + 6)),
            # plus max, denom, f32 dout and bf16 attn_l in; der, the bf16
            # [E, H*D] message and dattn_l out
            "gat_bwd": (lambda: gat_cuda.gat_bwd(*args, smax, denom, dout,
                                                 al_b),
                        lambda: gat_cuda.plain_gat_bwd(*args, smax, denom,
                                                       dout, al_b),
                        fwd_in + 2 * n * h * 4 + n * hd * 4 + hd * 2
                        + n * h * 4 + e * hd * 2 + hd * 4,
                        e * h * (9 * d + 18)),
        }
        for name, (kernel, plain, nbytes, ops) in cases.items():
            k_ms, p_ms = time_ms(kernel), time_ms(plain, iters=5)
            row = rows[name]
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bytes"] += nbytes
            row["ops"] += ops
            row["per_layer"][f"H={h},D={d}"] = dict(
                ms=k_ms, plain_ms=p_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log(f"time (H, D) = ({h}, {d}) {name}: kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bytes bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return [_row(name, row["ms"], row["plain_ms"], row["bytes"], row["ops"],
                 # no single PyTorch call computes fused GAT attention
                 None, launches, errs,
                 f"one GAT training step's two layers, (H, D) = (8, 16) and "
                 f"(1, 40), attention dropout {ATTN_DROP}, over N={n}, E={e}",
                 {"per_layer_ms": row["per_layer"]})
            for name, row in rows.items()]


def _library_csr(indptr, cols, vals, n):
    """A CSR matrix for the library call, whose rows need sorted, distinct
    columns; the kernels take each row's edges in any order."""
    from glnn_tpu_torch.ops.cuda_build import row_ids

    order = torch.argsort(row_ids(indptr, n) * n + cols.long())
    return torch.sparse_csr_tensor(indptr[: n + 1], cols[order], vals[order],
                                   (n, n), check_invariants=True)


def phase_times_weighted(spmm_cuda, g, launches: dict, errs: dict) -> list:
    """One APPNP training step's 20 weighted launches at F = 40 (10 forward
    walks, 10 transposed walks for dX, keep weights {0, 2}), and one
    forward per head at the GAT shapes, per width: kernel, plain version,
    library call (torch.sparse.mm with the weights as CSR values for the
    scalar weights, torch.bmm of a sparse [H, N, N] per head), bound.
    Bytes: f32 x rows, the weights, the indices (and t_edges on the
    transposed walk) and the f32 output."""
    from glnn_tpu_torch.ops.cuda_build import row_ids

    gen = torch.Generator(device=g.device).manual_seed(5)
    n, e = g.n_nodes, g.n_edges
    f = APPNP_F
    keep = torch.rand(e, generator=gen, device=g.device) >= EDGE_DROP
    w = keep.float() / (1.0 - EDGE_DROP)
    idx_bytes = 4 * (e + n + 1)
    per_width, tot = {}, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
                              ops=0)
    walks = {"forward": (g.indptr, g.senders, None, w),
             "transposed": (g.t_indptr, g.t_receivers, g.t_edges,
                            w[g.t_edges.long()])}
    for walk, (indptr, cols, widx, lib_w) in walks.items():
        x = torch.randn((n, f), generator=gen, device=g.device)
        kernel = lambda: spmm_cuda.csr_wsum_bf16(indptr, cols, widx, x, w, n)  # noqa: E731,E501
        plain = lambda: spmm_cuda.plain_csr_wsum_bf16(indptr, cols, widx, x,  # noqa: E731,E501
                                                      w, n)
        # with weights {0, 2}, bf16(x w) = bf16(x) w: the library call gets
        # the bf16-rounded rows in f32 and the weights as values
        adj, lib_x = _library_csr(indptr, cols, lib_w, n), x.to(
            torch.bfloat16).float()
        torch.testing.assert_close(torch.sparse.mm(adj, lib_x), kernel(),
                                   rtol=1e-5, atol=1e-4)
        nbytes = (n * f * 4 + e * 4 + idx_bytes + n * f * 4
                  + (e * 4 if widx is not None else 0))
        k_ms, p_ms = time_ms(kernel), time_ms(plain, iters=5)
        lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_x))
        per_width[f"F={f} {walk}"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", 2 * e * f)):
            tot[key] += APPNP_HOPS * val
        log(f"time F={f} {walk} walk spmm_csr_weighted: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, torch.sparse.mm f32 {lib_ms:.4f} ms, bytes "
            f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    dst, src = row_ids(g.indptr, n), g.senders.long()
    for tag, x, wh in weighted_cases(g, 6)[2:]:
        x2 = x.reshape(n, -1)
        h = wh.shape[1]
        nbytes = n * x2.shape[1] * 8 + e * h * 4 + idx_bytes
        kernel = lambda: spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None,  # noqa: E731,E501
                                                 x2, wh, n)
        # the library call: a sparse COO [H, N, N] of the weights times the
        # features as [H, N, D] (laid out before timing); it sums the f32
        # products unrounded, and each bf16 rounding moves a product by at
        # most 2**-9 of itself, so with a dst's weights summing to 1 the
        # two differ by at most 2**-9 x max|x| (atol 2**-8 x max|x|)
        heads = torch.arange(h, device=g.device).repeat_interleave(e)
        adj = torch.sparse_coo_tensor(
            torch.stack([heads, dst.repeat(h), src.repeat(h)]),
            wh.t().reshape(-1), (h, n, n)).coalesce()
        lib_x = x.permute(1, 0, 2).contiguous()
        torch.testing.assert_close(
            torch.bmm(adj, lib_x).permute(1, 0, 2).reshape(n, -1), kernel(),
            rtol=0, atol=2.0 ** -8 * x.abs().max().item())
        k_ms = time_ms(kernel)
        p_ms = time_ms(lambda: spmm_cuda.plain_csr_wsum_bf16(
            g.indptr, g.senders, None, x2, wh, n), iters=5)
        lib_ms = time_ms(lambda: torch.bmm(adj, lib_x), iters=5)
        per_width[f"H={h},D={x.shape[2]} forward"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        log(f"time {tag} spmm_csr_weighted forward: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, torch.bmm sparse [H, N, N] {lib_ms:.4f} "
            f"ms, bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        del adj, lib_x
    return [_row("spmm_csr_weighted", tot["ms"], tot["plain_ms"], tot["bytes"],
                 tot["ops"], tot["library_ms"], launches, errs,
                 f"one APPNP training step's {2 * APPNP_HOPS} launches at "
                 f"F={f} ({APPNP_HOPS} forward, {APPNP_HOPS} transposed for "
                 f"dX), keep weights {{0, 2}}, over N={n}, E={e}",
                 {"per_width_ms": per_width})]


def phase_times_softmax(gat_cuda, g, launches: dict, errs: dict) -> list:
    """The segment softmax at the GAT shapes' heads ([E, 8] and [E, 1]):
    kernel, plain version, bound; the forward also against
    torch.sparse.softmax over a COO [N, N] (x H) tensor, with the scores
    as values (hybrid for H = 8), and the backward against its VJP,
    torch._sparse_softmax_backward_data, on the same COO layout and the
    library's alpha. Bytes:
    the [E, H] inputs and output and indptr."""
    from glnn_tpu_torch.ops.cuda_build import row_ids

    gen = torch.Generator(device=g.device).manual_seed(8)
    n, e = g.n_nodes, g.n_edges
    dst = row_ids(g.indptr, n)
    order = torch.argsort(dst * n + g.senders.long())
    coo_idx = torch.stack([dst[order], g.senders.long()[order]])
    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0,
                       per_heads={})
            for name in ("edge_softmax_fwd", "edge_softmax_bwd")}
    for h, _ in GAT_SHAPES:
        s = 3.0 * torch.randn((e, h), generator=gen, device=g.device)
        da = torch.randn((e, h), generator=gen, device=g.device)
        alpha = gat_cuda.edge_softmax_fwd(g.indptr, s, n)
        vals = s[order] if h > 1 else s[order, 0]
        coo = torch.sparse_coo_tensor(coo_idx, vals, (n, n) + (
            (h,) if h > 1 else ()), check_invariants=True).coalesce()
        lib = torch.sparse.softmax(coo, 1)
        torch.testing.assert_close(
            lib.values().reshape(e, h), alpha[order], rtol=1e-5, atol=1e-6)
        lib_ms = time_ms(lambda: torch.sparse.softmax(coo, 1))
        dcoo = torch.sparse_coo_tensor(
            lib.indices(), da[order] if h > 1 else da[order, 0],
            lib.shape, check_invariants=True).coalesce()
        lib_bwd = lambda: torch._sparse_softmax_backward_data(  # noqa: E731
            dcoo, lib, 1, coo)
        # both backwards from the library's alpha: ds = a (da - t) cancels,
        # so a last-bit difference in alpha alone can move ds past 1e-6
        lib_alpha = torch.empty_like(alpha)
        lib_alpha[order] = lib.values().reshape(e, h)
        torch.testing.assert_close(
            lib_bwd().values().reshape(e, h),
            gat_cuda.edge_softmax_bwd(g.indptr, lib_alpha, da, n)[order],
            rtol=1e-4, atol=1e-6)
        lib_bwd_ms = time_ms(lib_bwd)
        cases = {
            "edge_softmax_fwd": (
                lambda: gat_cuda.edge_softmax_fwd(g.indptr, s, n),
                lambda: gat_cuda.plain_edge_softmax_fwd(g.indptr, s, n),
                2 * e * h * 4 + (n + 1) * 4, 5 * e * h, lib_ms),
            "edge_softmax_bwd": (
                lambda: gat_cuda.edge_softmax_bwd(g.indptr, alpha, da, n),
                lambda: gat_cuda.plain_edge_softmax_bwd(g.indptr, alpha, da,
                                                        n),
                3 * e * h * 4 + (n + 1) * 4, 4 * e * h, lib_bwd_ms),
        }
        for name, (kernel, plain, nbytes, ops, lib) in cases.items():
            k_ms, p_ms = time_ms(kernel), time_ms(plain, iters=5)
            row = rows[name]
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bytes"] += nbytes
            row["ops"] += ops
            row["library_ms"] += lib
            row["per_heads"][f"H={h}"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log(f"time scores [E, {h}] {name}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, library {lib:.4f} ms, bytes bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return [_row(name, row["ms"], row["plain_ms"], row["bytes"], row["ops"],
                 row["library_ms"], launches, errs,
                 f"the op-surface GAT layer's two shapes' softmax, scores "
                 f"[E, 8] and [E, 1], over N={n}, E={e}",
                 {"per_heads_ms": row["per_heads"]})
            for name, row in rows.items()]


def phase_times_hub(spmm_cuda, gat_cuda, hub, kernels: list) -> None:
    """One timing of each SpMM entry point at F = 40 and of gat_bwd at both
    GAT shapes (keep mask on) on the hub graph, where one warp walks each
    hub row alone; added to the rows' detail as `hub_graph_ms`, outside
    their sums."""
    gen = torch.Generator(device=hub.device).manual_seed(10)
    n, e = hub.n_nodes, hub.n_edges
    f = APPNP_F
    x = torch.randn((n, f), generator=gen, device=hub.device)
    xb = spmm_cuda.to_message(x)
    q, s = spmm_cuda.quantize_cols(x)
    w = (torch.rand(e, generator=gen, device=hub.device)
         >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
    idx_bytes = 4 * (e + n + 1)
    cases = {
        "spmm_csr_bf16": (lambda: spmm_cuda.csr_sum_bf16(
            hub.indptr, hub.senders, xb, n), n * f * 6 + idx_bytes),
        "spmm_csr_int8": (lambda: spmm_cuda.csr_sum_int8(
            hub.indptr, hub.senders, q, s, n), n * f * 5 + 4 * f + idx_bytes),
        "spmm_csr_weighted": (lambda: spmm_cuda.csr_wsum_bf16(
            hub.indptr, hub.senders, None, x, w, n),
            n * f * 8 + e * 4 + idx_bytes),
    }
    detail = {}
    for name, (kernel, nbytes) in cases.items():
        ms = time_ms(kernel)
        detail[name] = {f"F={f}": dict(
            ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)}
        log(f"time hub graph F={f} {name}: kernel {ms:.4f} ms, bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    detail["gat_bwd"] = {}
    for h, d in GAT_SHAPES:
        args, dout, al_b = gat_inputs(gat_cuda, hub, h, d, ATTN_DROP, 11)
        _, smax, denom = gat_cuda.gat_fwd(*args)
        ms = time_ms(lambda: gat_cuda.gat_bwd(*args, smax, denom, dout, al_b))
        detail["gat_bwd"][f"H={h},D={d}"] = dict(ms=ms)
        log(f"time hub graph (H, D) = ({h}, {d}) gat_bwd: kernel {ms:.4f} ms")
    for row in kernels:
        if row["name"] in detail:
            row["hub_graph_ms"] = detail[row["name"]]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from glnn_tpu_torch import ops
    from glnn_tpu_torch.graph.datasets import load_synth_data
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build(cuda_build)

    host, *_ = load_synth_data(DATASET, 0, 20, 30)
    dev = torch.device("cuda:0")
    g = host.to_device(dev)
    hub = hub_graph(g.n_nodes, g.n_edges, 9).to(dev)
    deg = torch.bincount(g.receivers.long(), minlength=g.n_nodes)
    log(f"graph {DATASET}: N={g.n_nodes}, E={g.n_edges}, in-degree max "
        f"{deg.max().item()}, mean {deg.float().mean().item():.2f}")
    log(f"hub graph: N={hub.n_nodes}, E={hub.n_edges}, in-degrees of rows "
        f"0-{len(HUB_DEGREES) - 1} "
        f"{hub.in_degrees[:len(HUB_DEGREES)].int().tolist()}, out-degrees "
        f"{hub.out_degrees[:len(HUB_DEGREES)].int().tolist()}")
    errs, hub_errs = {}, {}
    for tag, gr, into in (("smoke", g, errs), ("hub", hub, hub_errs)):
        log(f"checks on the {tag} graph")
        into.update(phase_check(spmm_cuda, gr))
        into.update(phase_check_gat(gat_cuda, gr))
        phase_check_gat_layer(gat_cuda, gr)
        into["spmm_csr_weighted"] = phase_check_weighted(spmm_cuda, gr)
        into.update(phase_check_softmax(gat_cuda, gr))
        log(f"{tag} graph: max|err| per kernel {into}")
        torch.cuda.empty_cache()
    for name, err in hub_errs.items():
        errs[name] = max(errs[name], err)
    op_surface = phase_op_surface(ops, cuda_build, spmm_cuda, gat_cuda, g)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main_path(cuda_build, spmm_cuda, gat_cuda, workdir)
    launches["op_surface"] = op_surface

    kernels = (phase_times(spmm_cuda, g, launches, errs)
               + phase_times_weighted(spmm_cuda, g, launches, errs)
               + phase_times_gat(gat_cuda, g, launches, errs)
               + phase_times_softmax(gat_cuda, g, launches, errs))
    phase_times_hub(spmm_cuda, gat_cuda, hub, kernels)
    for row in kernels:
        row["hub_graph_max_abs_err"] = hub_errs[row["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
