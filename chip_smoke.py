#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

    python3 chip_smoke.py        # from the repository root, on one CUDA GPU

Phases, each fatal on failure:
  1. build the CUDA kernels of every path from glnn_tpu_torch/csrc with
     nvcc for sm_90a (one nvcc per source, started together: spmm_csr.cu,
     spmm_f32.cu, gat_csr.cu) and log each
     kernel's ptxas register and spill counts; beside them, g++ builds the
     host-graph library from glnn_tpu_torch/csrc/graphops.cpp (its seconds
     logged), which must load: every path below runs the native tier;
  2. hold each kernel against its plain PyTorch version on the card, on the
     synth-n169343-c40-f128-d7 graph at the paths' shapes:
     - SpMM at the SAGE, GCN and APPNP widths (F = 40, 64, 128, 256) and
       at the dataset paths' widths (F = 100, 7, 2, each with its own lane
       layout; the max |error| per width in the kernels line):
       exact tier rtol 1e-5 / atol 1e-4 (only the summation order
       differs), int8 tier bit for bit (int32 sums are exact), and the
       gradient through the autograd.Function (the exact kernel's
       transposed walk) against the plain version of the backward at rtol
       1e-5 / atol 1e-4;
     - GAT (H, D) = (8, 16) and (1, 40): gat_prep against its plain
       version (the torch prep): bf16 features bit for bit, el at rtol
       1e-6 / atol 1e-6 x max|want| (summation order), er within one bf16
       ulp; then the same prep outputs into gat_fwd, gat_bwd and their
       plain versions, without dropout, with a keep mask and with a
       Philox seed (the plain versions apply philox_keep's mask): f32
       outputs (out, denom, der, dattn_l) at rtol 1e-4 / atol 1e-4 x
       max|want| (summation order), the segment max exactly, and the bf16
       message within one bf16 ulp (rtol 2**-7, atol 1e-5 x max|want|: a
       last-bit f32 difference can round either way), all inside the
       1e-2 x max bound that tests/test_pallas.py:489 puts on the Pallas
       gradients; and the seed mode bit-equal to the mask mode fed
       philox_keep's mask (every output of both kernels);
     - the GAT autograd layer at both shapes, seed mode: one backward
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
     - the f32 SpMM (feature_prop's hops) at F = 128 and 100 on the forward
       and the transposed walk: each element within 1e-5 of its row's
       magnitude (the sum of |x| over its edges; only the summation order
       differs), two launches bit-equal (the hub graph's rows of more than
       spmm_cuda.F32_CHUNK edges split across warps), and a 2-hop feature_prop
       against the plain hops at rtol 1e-5 / atol 1e-5 x max|want|;
     - the sampler at the SAGE path's batch (512) and fanouts (5, 10, 15):
       Floyd, the window tier with and without the aligned table, dedup
       mode with worst-case caps and with tight caps, on the card bit-equal
       to the CPU from the same uniforms, the tight caps overflowed; on the
       synth graph both window variants equal Floyd, on the hub graph every
       id sampled for a node of more than 64 in-edges lies in its fold
       window (its first 64 in-edges with the table, its in-window edges
       without);
     - both unweighted SpMM kernels on bf16 x at F = 128 and 256 through
       copy_u_sum / copy_u_sum_int8 (the bf16 compute tier): the exact
       tier's bf16 output within one bf16 ulp of the plain version's sum
       cast to bf16, the int8 tier bit for bit;
     all of it twice: on the synth graph, and on a hub graph of the same N
     and E whose first rows have HUB_DEGREES in- and out-edges (0 to
     20,000: every kernel walks a row in 32-edge chunks, and the synth
     graph's largest in-degree is 29), at the same tolerances; then, on
     the hub graph with its kept hub plans (spmm_cuda.plan_of), the
     kernels that split rows of more than T edges across warps (the SpMM
     template's three policies on both walks at T = spmm_cuda.HUB_CHUNK,
     gat_fwd and gat_bwd at both GAT shapes in seed mode at the GAT
     layer's T = gat_cuda.GAT_CHUNK, edge_softmax_fwd and edge_softmax_bwd
     on [E, 8] and [E, 1] at HUB_CHUNK): each against its plain version at
     the tolerances above, two launches bit-equal, every pass launched (two
     per call for the template and edge_softmax_bwd, three for the others)
     and one plan built per CSR and T;
     APPNP's hop fused into the template body's walks on the hub graph at
     F = 40 (spmm_cuda.appnp_wsum forward and transposed, appnp_sum_int8):
     each equal (torch.equal) to gcn_norm_both and the teleport on the
     kernels (dX by autograd), held to its plain version (the weighted
     walks at rtol 1e-5 / atol 1e-4 x max|want|, int8 bit for bit), two
     launches bit-equal, two a call; appnp_hop's dX and dh0 equal the
     composition's, and ops.appnp_hop takes the fused paths
     (ops.hop_counts) with no plain version on CUDA;
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
       0.01), then an MLP student; gat_prep and gat_fwd must launch exactly
       2 x (3 steps + 3 evals + 1 final eval) = 14 times, gat_bwd 2 x 3 = 6
       times, every training launch of both in seed mode (6 each, none
       with a mask), and the SpMM source reduce at least 6 times;
     - a full-batch GCN teacher at the published synth row (2 layers,
       hidden 64, dropout 0.5, weight decay 0.001; both layers aggregate
       after W, at F = 64 and 40), then an MLP student: spmm_csr_bf16
       exactly 2 x (3 + 3 + 1) = 14, spmm_csr_int8 2 x 3 = 6;
     - a full-batch APPNP teacher at the published synth row (MLP
       128 -> 128 -> 40, dropout 0.5, weight decay 0.01, then 10 hops,
       alpha 0.1, edge drop 0.5, all at F = 40), then an MLP student:
       spmm_csr_weighted exactly 10 x 3 x 2 = 60, spmm_csr_int8 10 x 3 =
       30, spmm_csr_bf16 10 (the final eval);
     - the inductive setting (--exp_setting ind --split_rate 0.2: 9,724
       inductive test nodes, an observed graph of 159,619 nodes): SAGE ind
       then an MLP student ind, spmm_csr_int8 exactly 3 layers x 3 evals x
       2 graphs = 18 and spmm_csr_bf16 3 x 2 = 6 (the final eval on both
       graphs; sampled training runs no kernel); GAT ind then MLP ind,
       gat_prep and gat_fwd 2 x (3 steps on the observed graph + 2 graphs
       x (3 evals + 1 final eval)) = 22, gat_bwd 6, all training launches
       in seed mode; each score line two finite scores;
     - a GCN teacher and an MLP student with --feature_aug_k 2
       --compute_min_cut --save_results: spmm_csr_f32 2 hops x 2 CLIs = 4
       (the teacher, GA2GCN, finds no config row and runs the defaults,
       hidden 128 without dropout: spmm_csr_bf16 2 x (3 + 1) + 3 = 11, one
       transposed walk a step, spmm_csr_int8 6); the runs land in
       aug_features/aug_hop_2/.../GA2GCN and GCN_GA2MLP, each model.ckpt
       loads into a fresh Model whose exact eval gives its out.npz again
       (1e-5), each loss_and_score.npz has a 7-field row per eval and each
       min_cut_loss holds a finite value;
     - "SAGE window bf16": the SAGE teacher with --sampler_tier window
       --compute_dtype bfloat16 (the aligned window table on the graph),
       then a bf16 MLP student, with --save_results: spmm_csr_int8 exactly
       3 layers x 3 evals = 9 and spmm_csr_bf16 3 (the final eval), on
       bf16 x; every floating tensor of both model.ckpt files f32;
     every other kernel exactly 0 on the GCN, APPNP, SAGE ind, feature
     aug and window bf16 paths; no plain version may run on a CUDA tensor, and each out.npz
     must hold finite [169343, 40] log-probs; on every path both runs'
     logs name the native host-graph tier and build_graph sorted natively
     (`native.counts`);
  4c. the distributed phase (--n_shards): N_SHARDS = 4 ranks share the
     card over gloo (GLNN_SHARE_DEVICE=1), each asserted to run on cuda:0.
     label_propagation_labels on the smoke graph, the native sweep bit for
     bit against the numpy tier, both timed. The smoke graph, relabelled
     by label-propagation communities as the
     teacher CLI relabels it, in 4 halo shards: on every rank the exact
     kernel's local and halo partials and both transposes against the plain
     version at F = 128 and 256 (rtol 1e-5 / atol 1e-4), each part and the
     halo exchange timed per rank, and the gathered halo_copy_u_sum
     against the single-device kernel sum; per rank, the per-edge halo ops
     over the shard's combined CSR against their plain versions: the fused
     halo GAT layer at both GAT shapes in seed mode (attention dropout
     0.3, the shard's edge_base), forward at rtol 1e-4 / atol 1e-4 x max,
     one backward (dfeat at 1e-2 x max, dattn_l / dattn_r at 1e-4), the
     halo softmax on [E_p, 8] and [E_p, 1] (phase 2's bounds), the halo
     weighted sum scalar at F = 40 with APPNP's {0, 2} weights and per
     head at (8, 16) (forward, dX, dW at rtol 1e-5 / atol 1e-4 x max), the
     per-op halo GAT layer against the fused one at phase 3's bound with
     its launches summed over the ranks (2 x 4 edge_softmax_fwd and _bwd,
     4 x 4 spmm_csr_weighted), the gathered fused layer against the
     single-device gat_cuda.gat_attention with the same seed (rtol 1e-4 /
     atol 1e-4 x max), and the exchanges against the kernels of one halo
     GAT layer and one APPNP hop, timed; a rectangular hub case (42,336
     rows over a 60,000-row buffer, rows of up to 20,000 edges) at F = 40.
     Then through the CLIs with --n_shards 4: SAGE (sampled,
     data-parallel; its evals on the halo graph) with --save_results and
     its data-parallel MLP student, GCN tran and GCN ind, GAT tran (the
     published row) with --save_results, APPNP tran and ind (the synth
     row); each out.npz checked, the launches summed over the ranks (the
     `launches` line of the run's log; each rank is a fresh process, its
     counts 0 at the start) exactly as predicted: 4 ranks x 2 partials x
     layers x (2 x steps + graphs x (evals + 1)) spmm_csr_bf16 (SAGE 72,
     GCN 112, GCN ind 160, each over 2 teacher epochs, one fewer than
     the other paths; the student and the int8 tier 0); GAT
     gat_prep and gat_fwd 4 x 2 x (3 + 4) = 56, gat_bwd, its source
     reduce (spmm_csr_bf16) and the seed-mode counts 4 x 2 x 3 = 24;
     APPNP spmm_csr_weighted 4 x 10 hops x 2 x 3 = 240 and spmm_csr_bf16
     4 x 2 x 10 x 4 = 320 (ind: 640); no plain version on CUDA; every
     run's log names the native host-graph tier, each teacher relabels
     once on the native tier (its log's relabel line, with its seconds)
     and sorts natively, the student sorts nothing (it builds no CSR); the
     SAGE
     and GAT teachers' out.npz against the single-device kernel eval of
     their saved weights (rtol 1e-4 / atol 1e-4); the data-parallel and
     halo epochs' seconds beside the single-process ones;
  4b. the datasets phase, in a temporary directory with 6 GB free (under
     TMPDIR, else beside this script): a file set per family at its
     published shape, synthetic contents from DATA_SEED (cora in the CPF
     npz schema, 2,708 nodes of which a core of 2,485 survives
     `standardize`, 1,433 binary CSR features, 7 classes; ogbn-arxiv in
     the OGB npz form, one direction of each non-loop edge of the smoke
     graph, so that the loader's reverse / remove / add self-loop rebuilds
     its 2,537,353 edges exactly; ogbn-products, built on the card:
     2,449,029 nodes, 100 features, 47 classes, 123,718,280 int32 edges of
     a planted partition, OGB's split sizes; penn94 .mat with 5 fixed
     splits of its labelled nodes: 41,554 nodes, about 1.36M edges, 4,801
     one-hot feature columns, gender 0/1/2; a small pokec .mat and a small
     BGNN house_class CSV set with int, float-with-NaN and categorical
     columns), each loaded through load_data and held against the arrays
     written, with no pandas, sklearn or ogb module imported; the host
     seconds of every write, load_data, build_graph (its native sorts by
     dst and by src apart from the rest) and .to(device); products'
     native dst permutation bit for bit against one
     np.argsort(kind="stable") of the same keys, both timed; the
     exact SpMM on the products graph at F = 100 against torch.sparse.mm
     (rtol 1e-5 / atol 1e-4; a plain gather would need a 49 GB message) and
     both timed beside the bytes bound, then one f32 hop (spmm_csr_f32) at
     F = 100 the same way, two launches bit-equal, timed eager and on the
     device beside the read-once and the all-miss bound; one sampled
     products epoch (49
     batches of 4096) and one all-node exact eval timed apart, with the
     peak device memory; then four paths through the CLIs with the
     package's own configs/train.conf.yaml, teacher then MLP student, the
     counts set to 0 before and read after each: OGB arxiv SAGE (3
     epochs; spmm_csr_int8 9, spmm_csr_bf16 3), CPF cora GCN and NonHom
     penn94 GCN (3 epochs; 14 exact, 6 int8; penn94's splits hold only
     labelled nodes, so no -1 label reaches the loss or a score) and OGB
     products SAGE (1 epoch; 3 and 3), each out.npz finite log-probs of
     the loaded graph's nodes and classes, no plain version on CUDA;
  4d. the experiment harness and the profiler traces: `python -m
     glnn_tpu_torch.experiments.run_experiments glnn_synth` with no
     --device (cuda:0) in a temporary work directory, four CLI children
     (SAGE and GLNN, tran and ind, on synth-n2048-c7-f128-d10-noise3.0,
     num_exp 2, max_epoch 50, patience 20): glnn_synth.txt's four labelled
     rows (2 scores and stds in tran, 4 in ind, each in [0, 1]), every
     child's log naming cuda:0 and the native host-graph tier, its
     launches line with no plain version on CUDA (the SAGE teachers on both
     SpMM tiers), exp_results and every seed's out.npz (finite, each row's
     logsumexp within 1e-4 of 0), no library under build/glnn_tpu_torch
     rebuilt by a child, and the aggregator over the tree exiting 0; each
     child's seconds and row logged beside the JAX package's record; the
     dry run of every experiment and of reproduce_all in process with
     subprocess.run failing (no child, nothing written). Then
     trace_and_report on cuda:0 at the smoke configuration of one GAT
     training step (the published synth GAT row, 3 traced calls), one
     exact all-node SAGE eval (3) and one sampled SAGE epoch (Floyd, f32;
     1), the counts set to 0 before each: every port kernel in the report
     counted as often as its counter moved over the traced calls, no plain
     version on CUDA, then one call untraced (what tracing costs); one
     `trace {...}` line each with the top 10 device ops, busy ms, window
     ms and the device idle share;
  5. time each kernel and its plain version with CUDA events (a kernel's
     `ms` from 20 calls back to back, which holds the wrapper's Python and
     launch overhead where that is the slower side; its device time from
     replays of a CUDA graph of those calls beside it as `device_ms`), and
     the library call where one computes the same function (torch.sparse.mm
     for the SpMM sums, torch.bmm of a sparse [H, N, N] for the per-head
     weighted sum, torch.sparse.softmax and its backward for the softmax;
     no single PyTorch call computes fused GAT attention or the int8
     tier's sum; torch.sparse.mm of the f32 CSR for the f32 SpMM at
     F = 128), and compute each kernel's bound: the GAT kernels in seed
     mode, as the path runs them (no mask bytes), with the mask mode's
     time and bound in the rows' detail; the f32 SpMM also beside its
     all-miss bound (every gathered row from device memory) and with its
     products F = 100 hop in its row; then time the SpMM kernels at
     F = 40 (the f32 one at F = 128), the GAT kernels at both GAT shapes
     and the softmax kernels at [E, 8] and [E, 1] on the hub graph with
     its kept plans, eager and on the device, each beside its synth-graph
     device time, and torch.sparse.softmax and its backward there (in the
     rows' detail as hub_graph_ms, outside their sums);
  6. time the sampled SAGE epoch in floyd/f32, window/f32 and window/bf16,
     and the all-node MLP student inference in f32 and bf16 (its log-probs
     within 3e-2 x max of f32's), each on a line with the card's name and
     power limit.
Prints the card's name and power limit and a `kernels` JSON line; the last
line is {"ok": true, "device": {...}}. Exits non-zero, with no result
line, when there is no CUDA device or the port is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DATASET = "synth-n169343-c40-f128-d7"
N_NODES, N_CLASSES = 169343, 40
TEACHER_EPOCHS = 3
# the sharded SAGE, GCN and GCN ind teachers (phase 4c) take one epoch
# fewer: a data-parallel SAGE epoch takes 12-17.5 s of host time on four
# ranks sharing the card, and the run must stay inside its time limit
SHARD_CUT_EPOCHS = TEACHER_EPOCHS - 1
# one distillation epoch per path: a student epoch is about 500 host-bound
# MLP steps (3-4 s at the ogbn-arxiv sizes) and launches no kernel
STUDENT_EPOCHS = 1
# per-class train/val counts that give ogbn-arxiv's split sizes on the
# synth graph's 40 round-robin classes: 90,920 train (arxiv 90,941) and
# 29,800 valid (29,799); the rest, 48,623, is test (48,603)
LABELRATE_TRAIN, LABELRATE_VAL = 2273, 745
WIDTHS = (128, 256, 256)     # F of the three SAGE layers' aggregations
GAT_SHAPES = ((8, 16), (1, 40))   # (heads, per-head width) of the 2 layers
ATTN_DROP = 0.3              # the GAT row's attention dropout
GCN_WIDTHS = (64, 40)        # F of the two GCN layers' aggregations
APPNP_F, APPNP_HOPS, EDGE_DROP = 40, 10, 0.5
SPLIT_RATE = 0.2             # --split_rate of the inductive paths
# the inductive split of the smoke sizes: int(48,623 x 0.2) inductive test
# nodes, and the rest in the observed graph
N_IND = 9724
N_OBS = N_NODES - N_IND
AUG_K, AUG_F = 2, 128        # --feature_aug_k, and the features it propagates
F32_WIDTHS = (AUG_F, 100)    # the f32 sum's checks: smoke and products widths
BATCH, FANOUTS = 512, (5, 10, 15)   # the SAGE row's batch and fan_out
# the "SAGE window bf16" path's options; --save_results for its checkpoints
WINDOW_BF16 = ("--sampler_tier", "window", "--compute_dtype", "bfloat16",
               "--save_results")
TIMED_EPOCHS = 3             # per sampler tier and dtype, after one warmup
# in-degrees (and out-degrees) of the hub graph's first rows: empty, one
# edge, either side of one and two 32-edge chunks, and two long rows
HUB_DEGREES = (0, 1, 31, 32, 33, 64, 65, 1000, 20000)
# the datasets phase: a file set per family at its published shape, the
# contents synthetic, from DATA_SEED
DATA_SEED = 31
CORA_NODES, CORA_FEATS, CORA_CLASSES = 2708, 1433, 7
CORA_LCC, CORA_EDGES = 2485, 5278    # nodes of the core; edges written
ARXIV_SPLIT = (90941, 29799, 48603)  # OGB's train / valid / test sizes
PRODUCTS_NODES, PRODUCTS_FEATS, PRODUCTS_CLASSES = 2449029, 100, 47
PRODUCTS_PAIRS = 61859140            # both directions: 123,718,280 edges
PRODUCTS_SPLIT = (196615, 39323, 2213091)
PRODUCTS_BATCH = 4096                # the ogbn-products SAGE row's batch
PENN94_NODES, PENN94_PAIRS = 41554, 681200
# values of local_info's 7 columns (status, gender, major, minor, dorm, a
# two-valued column, high school): 4,801 one-hot columns without gender
PENN94_RANGES = (6, 3, 201, 201, 61, 2, 4331)
POKEC_NODES, POKEC_EDGES = 5000, 30000
HOUSE_NODES, HOUSE_EDGES = 2000, 12000
DATASET_WIDTHS = (100, 7, 2)   # SAGE layer 1 on products, GCN layer 2 on
                               # cora and on penn94
MIN_FREE_DISK = 6e9            # bytes the dataset files need (products ~2 GB)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 peak rate
FP32_OPS_PER_S = 67e12       # H100 SXM, outside the tensor cores
SOURCES = {"spmm_csr_bf16": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "spmm_csr_int8": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "spmm_csr_weighted": "glnn_tpu_torch/csrc/spmm_csr.cu",
           "spmm_csr_f32": "glnn_tpu_torch/csrc/spmm_f32.cu",
           "gat_prep": "glnn_tpu_torch/csrc/gat_csr.cu",
           "gat_fwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "gat_bwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "edge_softmax_fwd": "glnn_tpu_torch/csrc/gat_csr.cu",
           "edge_softmax_bwd": "glnn_tpu_torch/csrc/gat_csr.cu"}
REPLACES = {
    "spmm_csr_bf16": "glnn_tpu/ops/spmm_pallas.py:93 (_block_kernel) and "
                     "glnn_tpu/ops/spmm_pallas.py:59 (_kernel)",
    "gat_prep": "glnn_tpu/ops/gat_pallas.py:118 (el in _scores_block, in "
                "_gat_fwd_kernel :158) and :409 (_prep, er)",
    "gat_fwd": "glnn_tpu/ops/gat_pallas.py:158 (_gat_fwd_kernel)",
    "gat_bwd": "glnn_tpu/ops/gat_pallas.py:187 (_gat_bwd_kernel)",
    "edge_softmax_fwd": "glnn_tpu/ops/gat_pallas.py:694 (_smx_fwd_kernel)",
    "edge_softmax_bwd": "glnn_tpu/ops/gat_pallas.py:712 (_smx_bwd_kernel)",
}
REPLACES["spmm_csr_int8"] = REPLACES["spmm_csr_bf16"]
REPLACES["spmm_csr_f32"] = (
    "none: the f32 XLA segment sum glnn_tpu/ops/refops.py:37 (copy_u_sum) "
    "under glnn_tpu/ops/graph_utils.py:22 (feature_prop) reaches no "
    "pallas_call")
REPLACES["spmm_csr_weighted"] = (REPLACES["spmm_csr_bf16"] + ", weighted "
                                 "(u_mul_e_sum, glnn_tpu/ops/spmm_pallas.py:438)")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of `fn` called `iters` times in a row, from
    CUDA events: the device time where the device is the slower side, the
    host's (Python, launch) where the host is."""
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


def kernel_times(fn, iters: int = 20, replays: int = 5) -> tuple:
    """(eager ms, device ms) per call of a kernel's wrapper `fn`: time_ms of
    the calls made back to back, and the device time from CUDA events
    around replays of a CUDA graph that holds `iters` calls, which leaves
    the wrapper's Python and launch overhead out."""
    eager = time_ms(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    return eager, start.elapsed_time(stop) / (replays * iters)


def phase_build(cuda_build, native) -> None:
    """One nvcc per CUDA source and g++ for the host-graph library, all
    started together; the library must load (the native tier)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (native.build(force=True),
                                    time.perf_counter() - t0))
        messages = cuda_build.build(force=True)
        cuda_s = time.perf_counter() - t0
        lib, host_s = host.result()
    if lib is None or not native.available():
        raise AssertionError(f"the host-graph library did not build: "
                             f"{native.describe()}")
    log(f"build: nvcc {' '.join(cuda_build.NVCC_FLAGS)}, one per source, "
        f"{sorted(cuda_build.SOURCES.values())} in {cuda_s:.2f} s")
    log(f"build: g++ {' '.join(native.CXX_FLAGS)} "
        f"{os.path.relpath(native.SOURCE, os.path.dirname(__file__))}, "
        f"beside nvcc, in {host_s:.2f} s; host graph ops: "
        f"{native.describe()}")
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


def phase_check(spmm_cuda, g, per_width: dict) -> dict:
    """SpMM kernels vs plain versions on the card; max |error| per kernel,
    and per F of DATASET_WIDTHS into `per_width`."""
    gen = torch.Generator(device=g.device).manual_seed(0)
    n = g.n_nodes
    errs = {name: 0.0 for name in spmm_cuda.KERNELS}
    for f in sorted(set(WIDTHS + GCN_WIDTHS + DATASET_WIDTHS)):
        width = {}
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        got = spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n)
        want = spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        err = (got - want).abs().max().item()
        errs["spmm_csr_bf16"] = max(errs["spmm_csr_bf16"], err)
        width["exact"] = err
        log(f"check F={f}: exact kernel vs plain max|err| {err:.3e}")

        q, s = spmm_cuda.quantize_cols(x)
        got = spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n)
        want = spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s, n)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"int8 kernel differs from plain at F={f}: "
                                 f"{err}")
        errs["spmm_csr_int8"] = max(errs["spmm_csr_int8"], err)
        width["int8"] = err
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
            width[f"{tier} gradient"] = err
            log(f"check F={f}: {tier} tier gradient vs plain max|err| "
                f"{err:.3e}")
        if f in DATASET_WIDTHS:
            per_width[f] = width
    return errs


def sampler_cases(g, seeds):
    """(tag, graph, kwargs) of every sampler tier and frontier mode the
    checks hold on the card: Floyd, the window tier with and without the
    aligned table, dedup with worst-case caps and with tight caps (which
    must overflow)."""
    from glnn_tpu_torch.sampling import frontier_caps

    worst = frontier_caps(len(seeds), FANOUTS, g.n_nodes)
    tight = [8 * len(seeds), 4 * len(seeds), 2 * len(seeds), len(seeds)]
    table = g.with_window_table()
    return [("floyd", g, {}),
            ("window, table", table, {"method": "window"}),
            ("window, no table", g, {"method": "window"}),
            ("dedup worst caps, floyd", g, {"caps": worst}),
            ("dedup tight caps, window", table,
             {"caps": tight, "method": "window"})]


def _uniforms(seeds, kwargs, gen):
    """Each hop's uniforms for a frontier of the size the mode gives it."""
    caps = kwargs.get("caps")
    sizes, c = [0] * len(FANOUTS), len(seeds)
    for i in range(len(FANOUTS) - 1, -1, -1):
        sizes[i] = c
        c = caps[i] + 1 if caps else c * (FANOUTS[i] + 1)
    return [torch.rand((c, f), generator=gen) for c, f in zip(sizes, FANOUTS)]


def _same_blocks(a, b) -> bool:
    return (torch.equal(a.input_nodes.cpu(), b.input_nodes.cpu())
            and bool(a.overflowed) == bool(b.overflowed)
            and all(torch.equal(x.cpu(), y.cpu())
                    for field in ("nbr_local", "valid", "self_local",
                                  "out_real")
                    for x, y in zip(getattr(a, field), getattr(b, field))))


def phase_check_sampler(g, tag: str) -> None:
    """The sampler on the card against the CPU from the same uniforms, at
    the SAGE path's batch and fanouts: every tier and mode bit-equal, and
    the tight caps overflowed. On the smoke graph (in-degrees <= 29) the
    window tier equals Floyd; on the hub graph every id the window tier
    samples for a node of more than 64 in-edges lies in its fold window:
    its first 64 in-edges with the table, its in-window edges without."""
    from glnn_tpu_torch.sampling import sample_blocks

    gen = torch.Generator().manual_seed(21)
    n = g.n_nodes
    hubs = [i for i, d in enumerate(HUB_DEGREES) if d > 64]
    if tag == "hub":          # every hub of more than 64 in-edges, and more
        seeds = torch.cat([torch.tensor(hubs), torch.randint(
            len(HUB_DEGREES), n, (BATCH - len(hubs) - 2,), generator=gen)])
    else:
        seeds = torch.randint(0, n, (BATCH - 2,), generator=gen)
    seeds = torch.cat([seeds, torch.full((2,), n)]).to(torch.int32)
    g_cpu = g.to("cpu")
    blocks = {}
    concat_uniforms = _uniforms(seeds, {}, gen)   # the same for every tier
    for name, gr, kwargs in sampler_cases(g, seeds):
        uniforms = (_uniforms(seeds, kwargs, gen) if kwargs.get("caps")
                    else concat_uniforms)
        got = sample_blocks(gr, seeds.to(g.device), FANOUTS,
                            uniforms=uniforms, **kwargs)
        want = sample_blocks(dataclasses.replace(g_cpu, win1=gr.win1), seeds,
                             FANOUTS, uniforms=uniforms, **kwargs)
        torch.cuda.synchronize()
        if not _same_blocks(got, want):
            raise AssertionError(f"sampler {name} on the {tag} graph: the card "
                                 f"differs from the CPU")
        # (worst-case caps stop at N, so a frontier holding every node and
        # the ghost id sets the flag too, as in JAX)
        if "tight" in name and not bool(got.overflowed):
            raise AssertionError(f"sampler {name} on the {tag} graph did not "
                                 f"overflow")
        log(f"check sampler {name} ({tag} graph, batch {BATCH}, fanouts "
            f"{FANOUTS}): card bit-equal to CPU, frontier "
            f"{got.input_nodes.numel()}, overflowed {bool(got.overflowed)}")
        if not kwargs.get("caps"):
            blocks[name] = got
    if tag == "smoke":
        if int(g.in_degrees.max()) > 64:
            raise AssertionError("the smoke graph has in-degrees over 64")
        for name in ("window, table", "window, no table"):
            if not _same_blocks(blocks[name], blocks["floyd"]):
                raise AssertionError(f"sampler {name} differs from Floyd "
                                     f"below in-degree 64")
        log("check sampler: both window variants equal Floyd on the smoke "
            "graph (in-degrees <= 29)")
        return
    indptr, senders = g_cpu.indptr.long(), g_cpu.senders
    for name in ("window, table", "window, no table"):
        nbr = blocks[name].input_nodes.cpu()[len(seeds):len(seeds) * (FANOUTS[-1] + 1)]
        nbr = nbr.view(len(seeds), FANOUTS[-1])
        for i, v in enumerate(hubs):
            start, deg = int(indptr[v]), int(indptr[v + 1] - indptr[v])
            cap = 64 if "no table" not in name else min(deg, 128 - start % 64)
            allowed = set(senders[start:start + cap].tolist())
            if not set(nbr[i].tolist()) <= allowed:
                raise AssertionError(f"sampler {name}: hub {v} (in-degree "
                                     f"{deg}) sampled outside its window")
        log(f"check sampler {name}: hubs of in-degree "
            f"{[HUB_DEGREES[v] for v in hubs]} sample only inside their fold "
            f"window")


def phase_check_bf16(spmm_cuda, g) -> dict:
    """Both unweighted SpMM kernels on bf16 x at the SAGE widths through
    copy_u_sum / copy_u_sum_int8, as the bf16 compute tier calls them: the
    exact tier's bf16 output within one bf16 ulp of the plain version's f32
    sum cast to bf16 (rtol 2**-7, atol 1e-5 x max|want|: a last-bit f32
    difference can round either way), the int8 tier's bit for bit (q and s
    from the same quantize_cols, exact int32 sums)."""
    gen = torch.Generator(device=g.device).manual_seed(22)
    n = g.n_nodes
    errs = {"spmm_csr_bf16": 0.0, "spmm_csr_int8": 0.0}
    for f in sorted(set(WIDTHS)):
        x = torch.randn((n, f), generator=gen, device=g.device).bfloat16()
        got = spmm_cuda.copy_u_sum(g, x)
        want = spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, x, n)
        q, s = spmm_cuda.quantize_cols(x)
        got_q = spmm_cuda.copy_u_sum_int8(g, x)
        want_q = spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s, n)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or got_q.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 x gave {got.dtype} / {got_q.dtype}")
        err = _held("bf16 x exact tier", got, want.bfloat16(), 2.0 ** -7, 1e-5)
        if not torch.equal(got_q, want_q.bfloat16()):
            raise AssertionError(f"int8 tier on bf16 x differs from plain at "
                                 f"F={f}")
        errs["spmm_csr_bf16"] = max(errs["spmm_csr_bf16"], err)
        log(f"check F={f}, bf16 x: exact tier vs plain cast to bf16 max|err| "
            f"{err:.3e} (max|want| {want.abs().max().item():.3e}); int8 tier "
            f"bit-equal")
    return errs


def phase_check_f32(spmm_cuda, refops, g) -> float:
    """spmm_csr_f32 (feature_prop's hops) vs its plain version on the card
    at F = 128 and 100 (F32_WIDTHS), on the forward and the transposed walk:
    f32 rows summed in f32 in another order, so each output element within
    1e-5 of its row's magnitude (the sum of |x| over the row's edges, far
    above the rounding of either order), and a second launch bit-equal to
    the first (rows of more than spmm_cuda.F32_CHUNK edges are split across
    warps, their partials summed in chunk order, with no atomics); then one
    feature_prop of AUG_K hops against the same hops through the plain
    version."""
    from glnn_tpu_torch.ops.graph_utils import feature_prop

    gen = torch.Generator(device=g.device).manual_seed(13)
    n = g.n_nodes
    err = 0.0
    for f in F32_WIDTHS:
        x = torch.randn((n, f), generator=gen, device=g.device)
        for walk, indptr, cols in (("forward", g.indptr, g.senders),
                                   ("transposed", g.t_indptr, g.t_receivers)):
            plan = spmm_cuda.hub_plan(indptr, n, spmm_cuda.F32_CHUNK)
            got = spmm_cuda.csr_sum_f32(indptr, cols, x, n, plan)
            again = spmm_cuda.csr_sum_f32(indptr, cols, x, n, plan)
            want = refops.csr_sum_f32(indptr, cols, x, n)
            mag = refops.csr_sum_f32(indptr, cols, x.abs(), n)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not bool((diff <= 1e-5 * mag).all()):
                raise AssertionError(f"spmm_csr_f32 F={f} {walk} walk: max "
                                     f"|err| {diff.max().item():.3e} over "
                                     f"1e-5 of its row's magnitude")
            if not torch.equal(got, again):
                raise AssertionError(f"spmm_csr_f32 F={f} {walk} walk: two "
                                     f"launches differ")
            err = max(err, diff.max().item())
            log(f"check F={f}: spmm_csr_f32 {walk} walk vs plain max|err| "
                f"{diff.max().item():.3e} (max row magnitude "
                f"{mag.max().item():.3e}); {plan.rows.numel()} rows split "
                f"into {plan.n_chunks} chunks; two launches bit-equal")
    x = torch.randn((n, AUG_F), generator=gen, device=g.device)
    got = feature_prop(x, g, AUG_K)
    norm = torch.rsqrt(g.in_degrees.clamp(min=1.0))[:, None]
    want = x
    for _ in range(AUG_K):
        want = refops.csr_sum_f32(g.indptr, g.senders, want * norm, n) * norm
    torch.cuda.synchronize()
    err = max(err, _held("feature_prop", got, want, 1e-5, 1e-5))
    log(f"check feature_prop, {AUG_K} hops at F={AUG_F}: vs plain max|err| "
        f"{(got - want).abs().max().item():.3e}")
    return err


def gat_inputs(gat_cuda, g, h, d, drop, seed, mode="seed"):
    """The kernels' inputs at one layer's shape: prep of random features
    and attention vectors, when drop > 0 a Philox seed (mode "seed", as
    the path runs) or a keep mask (mode "mask"), and a cotangent."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, dev = g.n_nodes, g.device
    feat = torch.randn((n, h, d), generator=gen, device=dev)
    al = 0.3 * torch.randn((h, d), generator=gen, device=dev)
    ar = 0.3 * torch.randn((h, d), generator=gen, device=dev)
    keep = None
    if drop and mode == "seed":
        keep = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                             generator=gen, device=dev)
    elif drop:
        keep = torch.rand((g.n_edges, h), generator=gen, device=dev) >= drop
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


def check_prep(gat_cuda, g, h, d) -> float:
    """gat_prep against its plain version (the torch prep) on the card."""
    gen = torch.Generator(device=g.device).manual_seed(h + d + 20)
    feat = torch.randn((g.n_nodes, h, d), generator=gen, device=g.device)
    al, ar = (0.3 * torch.randn((h, d), generator=gen, device=g.device)
              for _ in range(2))
    got = gat_cuda.prep(feat, al, ar)
    want = gat_cuda.plain_prep(feat, al, ar)
    torch.cuda.synchronize()
    for name, i in (("feat_b", 0), ("al_b", 3)):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"gat_prep {name} differs from the plain "
                                 f"version at (H, D) = ({h}, {d})")
    errs = {"el": _held("prep el", got[1], want[1], 1e-6, 1e-6),
            "er": _held("prep er", got[2], want[2], 2.0 ** -7, 1e-6)}
    log(f"check (H, D) = ({h}, {d}): gat_prep vs plain max|err| " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + ", feat_b bit-equal")
    return max(errs.values())


def phase_check_gat(gat_cuda, g) -> dict:
    """GAT kernels vs plain versions on the card; max |error| per kernel."""
    errs = {name: 0.0 for name in gat_cuda.KERNELS}
    for h, d in GAT_SHAPES:
        errs["gat_prep"] = max(errs["gat_prep"], check_prep(gat_cuda, g, h, d))
        for drop, mode in ((0.0, None), (ATTN_DROP, "mask"),
                           (ATTN_DROP, "seed")):
            args, dout, al_b = gat_inputs(gat_cuda, g, h, d, drop, h + d,
                                          mode)
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
            tag = f"(H, D) = ({h}, {d}), dropout {drop}" + (
                f" ({mode})" if mode else "")
            log(f"check {tag}: gat_fwd vs plain max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in e_fwd.items()) + ", max exact")
            log(f"check {tag}: gat_bwd vs plain max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in e_bwd.items()))
            if mode == "seed":
                check_seed_is_mask(gat_cuda, args, dout, al_b,
                                   (out, smax, denom) + tuple(got), tag)
            del out, got, want, w_out
    return errs


def check_seed_is_mask(gat_cuda, args, dout, al_b, seeded, tag) -> None:
    """Seed mode bit-equal to mask mode fed philox_keep's mask: the same
    arithmetic, so one differing keep bit would show."""
    indptr, senders, feat_b, el, er_b, seed, inv_keep, slope = args
    mask = gat_cuda.philox_keep(seed, senders.numel(), feat_b.shape[1],
                                1.0 / inv_keep)
    margs = (indptr, senders, feat_b, el, er_b, mask, inv_keep, slope)
    out, smax, denom = gat_cuda.gat_fwd(*margs)
    masked = (out, smax, denom) + tuple(
        gat_cuda.gat_bwd(*margs, smax, denom, dout, al_b))
    torch.cuda.synchronize()
    names = ("out", "max", "denom", "der", "msg", "dattn_l")
    for name, a, b in zip(names, seeded, masked):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: seed mode {name} differs from the "
                                 f"mask mode fed philox_keep's mask")
    log(f"check {tag}: seed mode bit-equal to mask mode with philox_keep's "
        f"mask (kept share {mask.float().mean().item():.4f})")


def phase_check_gat_layer(gat_cuda, g) -> None:
    """One backward of the autograd layer (gat_prep, gat_fwd, gat_bwd, the
    SpMM source reduce over t_indptr/t_edges, der * attn_r, the dattn_r
    einsum) at each path shape, dropout in seed mode as the path runs it,
    against the plain chain: plain_prep, plain_gat_fwd and plain_gat_bwd
    with philox_keep's mask, the message summed over senders with
    index_add_."""
    n, dev = g.n_nodes, g.device
    inv_keep = 1.0 / (1.0 - ATTN_DROP)
    for h, d in GAT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(100 + h * d)
        feat = torch.randn((n, h, d), generator=gen, device=dev)
        al = 0.3 * torch.randn((h, d), generator=gen, device=dev)
        ar = 0.3 * torch.randn((h, d), generator=gen, device=dev)
        seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                             generator=gen, device=dev)
        dout = torch.randn((n, h, d), generator=gen, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        gat_cuda.gat_attention(g, *leaves, 0.2, seed, inv_keep).backward(dout)

        feat_b, el, er_b, al_b = gat_cuda.plain_prep(feat, al, ar)
        keep = gat_cuda.philox_keep(seed, g.n_edges, h, 1.0 - ATTN_DROP)
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
        log(f"check (H, D) = ({h}, {d}), dropout {ATTN_DROP} (seed): autograd "
            f"layer "
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


def run_dir(workdir: str, sub: str, model: str, dataset=DATASET) -> str:
    """A CLI run's directory under workdir/outputs."""
    return os.path.join(workdir, "outputs", sub, dataset, model, "seed_0")


def check_out(path: str, tag: str, shape=(N_NODES, N_CLASSES)) -> np.ndarray:
    """out.npz at `path`: finite log-probs of `shape` ([nodes, classes])."""
    out = np.load(path)["arr_0"]
    lse = np.log(np.exp(out.astype(np.float64)).sum(axis=1))
    if out.shape != tuple(shape) or not np.isfinite(out).all():
        raise AssertionError(f"{tag} out.npz: shape {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    if np.abs(lse).max() > 1e-4:
        raise AssertionError(f"{tag} out.npz rows are not log-probs: max "
                             f"|logsumexp| {np.abs(lse).max()}")
    log(f"{tag} out.npz: {out.shape} finite, max |logsumexp| "
        f"{np.abs(lse).max():.2e}")
    return out


EPOCH_LINES = {}    # path tag -> its teacher's "mean epoch time" line
PLAN_BUILDS = {}    # path tag -> the hub plans it built (spmm_cuda.builds)


def drive_path(teacher: str, workdir: str, common: list, modules,
               extra=(), sub="transductive", names=None, dataset=DATASET,
               shape=(N_NODES, N_CLASSES), epochs=TEACHER_EPOCHS) -> dict:
    """Teacher (`epochs` epochs) then MLP student through the CLIs with the
    options `extra`, the counts of `modules` set to 0 just before and read
    just after; checks both score lines (two scores each in ind) and both
    out.npz ([nodes, classes] = `shape`) under outputs/<sub>/<dataset>, the
    runs' directories `names` (teacher, student; by default the option-free
    names)."""
    from glnn_tpu_torch import native
    from glnn_tpu_torch.cli import train_student, train_teacher

    names = names or (teacher, f"{teacher}_MLP")
    tag = " ".join(([dataset] if dataset != DATASET else [])
                   + [teacher, *extra])
    printed = [io.StringIO(), io.StringIO()]
    for module in modules:
        module.reset_counts()
    native.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed[0]):
        train_teacher.main(common + ["--teacher", teacher, "--max_epoch",
                                     str(epochs), *extra])
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed[1]):
        train_student.main(
            common + ["--teacher", teacher, "--student", "MLP", "--max_epoch",
                      str(STUDENT_EPOCHS), "--out_t_path",
                      os.path.join(workdir, "outputs"), *extra])
    t2 = time.perf_counter()
    counts = {k: v for module in modules for k, v in module.counts.items()}
    PLAN_BUILDS[tag] = sum(getattr(module, "builds", {}).get("hub_plan", 0)
                           for module in modules)
    log(f"{tag} path: teacher {t1 - t0:.2f} s ({epochs} epochs), "
        f"student {t2 - t1:.2f} s ({STUDENT_EPOCHS} epochs); counts {counts}; "
        f"hub plans built {PLAN_BUILDS[tag]}; host graph ops {native.counts}")
    if not native.counts["sort_edges"]:
        raise AssertionError(f"the {tag} path sorted no edges natively: "
                             f"{native.counts}")
    for model in names:
        log_path = os.path.join(run_dir(workdir, sub, model, dataset), "log")
        check_native_tier(f"{tag} {model}", log_path)
        with open(log_path) as f:
            for line in f:
                if any(k in line for k in ("mean epoch time", "Best valid",
                                           "Observed graph")):
                    log(f"  {model} log: {line.split(': ', 1)[1].strip()}")
                if model == names[0] and "mean epoch time" in line:
                    EPOCH_LINES[tag] = line.split(": ", 1)[1].strip()

    n_scores = 2 if "ind" in extra else 1
    for model, text in zip(names, printed):
        score = text.getvalue().strip()
        print(score)
        if (len(score.split()) != n_scores
                or not all(math.isfinite(float(s)) for s in score.split())):
            raise AssertionError(f"{model} printed no line of {n_scores} "
                                 f"finite scores: {score!r}")
        check_out(os.path.join(run_dir(workdir, sub, model, dataset),
                               "out.npz"), model, shape)
    if counts["plain_on_cuda"]:
        raise AssertionError(f"{counts['plain_on_cuda']} plain-version calls "
                             f"on CUDA tensors on the {tag} path")
    return counts


def check_native_tier(tag: str, log_path: str) -> None:
    """The run's log names the native tier of the host-graph library."""
    with open(log_path) as f:
        if "host graph ops: native (" not in f.read():
            raise AssertionError(f"the {tag} log does not name the native "
                                 f"host-graph tier")


def check_counts(tag: str, got: dict, launched: dict) -> None:
    """Every kernel launched exactly as `launched` says, the others 0."""
    want = dict.fromkeys(got, 0)
    want.update(launched)
    if got != want:
        raise AssertionError(f"the {tag} path launched {got}, expected {want}")


def gat_counts(evals: int, graphs: int) -> dict:
    """The GAT path's launches of the two-layer teacher: TEACHER_EPOCHS
    training steps (dropout from a seed), `evals` intermediate evals and one
    final eval, each eval on `graphs` graphs."""
    layers = len(GAT_SHAPES)
    forwards = layers * (TEACHER_EPOCHS + graphs * (evals + 1))
    return {"gat_prep": forwards, "gat_fwd": forwards,
            "gat_bwd": layers * TEACHER_EPOCHS,
            "gat_fwd_seed": layers * TEACHER_EPOCHS, "gat_fwd_mask": 0,
            "gat_bwd_seed": layers * TEACHER_EPOCHS, "gat_bwd_mask": 0}


def check_gat(tag: str, got: dict, want: dict) -> None:
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{name} launched {got[name]} times on the "
                                 f"{tag} path, expected {n}")
    if got["spmm_csr_bf16"] < want["gat_bwd"]:
        raise AssertionError(f"the GAT backward's source reduce launched "
                             f"{got['spmm_csr_bf16']} times on the {tag} "
                             f"path, expected at least {want['gat_bwd']}")


def check_saved(workdir: str, cfg: str, sub: str, names, host, g) -> None:
    """--save_results and --compute_min_cut of the feature-aug path, whose
    runs `names` lie under outputs/<sub>: each run's model.ckpt loads into a
    fresh Model whose exact eval on the propagated features gives its
    out.npz again (1e-5), loss_and_score.npz has a 7-field row per eval,
    and min_cut_loss holds a finite value."""
    from glnn_tpu_torch.cli import train_teacher
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.ops.graph_utils import feature_prop
    from glnn_tpu_torch.train import make_eval_fn
    from glnn_tpu_torch.utils import get_training_config, load_model
    from glnn_tpu_torch.utils.config import merge_args_with_config

    feats = feature_prop(torch.as_tensor(host.ndata["feat"], device=g.device),
                         g, AUG_K)
    args = vars(train_teacher.get_args([]))
    for name in names:
        path = run_dir(workdir, sub, name)
        conf = merge_args_with_config(
            dict(args, feat_dim=AUG_F, label_dim=N_CLASSES),
            get_training_config(cfg, name.split("_")[-1], DATASET))
        model = Model(conf).to(g.device)
        model.load_state_dict(load_model(os.path.join(path, "model.ckpt")))
        got = make_eval_fn(model, exact=True)(None if model.is_mlp else g,
                                              feats).cpu().numpy()
        want = np.load(os.path.join(path, "out.npz"))["arr_0"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name}: model.ckpt's eval")
        rows = np.load(os.path.join(path, "loss_and_score.npz"))["arr_0"]
        if rows.shape != (TEACHER_EPOCHS if name == names[0]
                          else STUDENT_EPOCHS, 7):
            raise AssertionError(f"{name} loss_and_score.npz {rows.shape}")
        with open(os.path.join(os.path.dirname(path), "min_cut_loss")) as f:
            cut = [float(v) for v in f.read().split()]
        if len(cut) != 1 or not math.isfinite(cut[0]):
            raise AssertionError(f"{name} min_cut_loss {cut}")
        log(f"{name}: model.ckpt's exact eval gives out.npz again, max|err| "
            f"{np.abs(got - want).max():.2e}; loss_and_score {rows.shape}; "
            f"min-cut loss {cut[0]}")


def common_args(cfg: str, workdir: str) -> list:
    """The options every path's CLIs share, with outputs under workdir."""
    return ["--device", "0", "--dataset", DATASET, "--eval_interval", "1",
            "--labelrate_train", str(LABELRATE_TRAIN),
            "--labelrate_val", str(LABELRATE_VAL),
            "--model_config_path", cfg, "--output_path",
            os.path.join(workdir, "outputs")]


def check_window_bf16(workdir: str) -> None:
    """The "SAGE window bf16" path's runs: the teacher's conf took the
    window tier and bf16, and every floating tensor of both saved models
    (parameters and batch-norm statistics) is f32."""
    from glnn_tpu_torch.utils import load_model

    with open(os.path.join(run_dir(workdir, "transductive", "SAGE"),
                           "log")) as f:
        text = f.read()
    for want in ("'sampler_tier': 'window'", "'compute_dtype': 'bfloat16'"):
        if want not in text:
            raise AssertionError(f"the window bf16 teacher's log lacks {want}")
    for model in ("SAGE", "SAGE_MLP"):
        state = load_model(os.path.join(
            run_dir(workdir, "transductive", model), "model.ckpt"))
        bad = {k: v.dtype for k, v in state.items()
               if v.is_floating_point() and v.dtype != torch.float32}
        if bad:
            raise AssertionError(f"{model} saved non-f32 tensors {bad}")
        log(f"{model} (window, bf16) model.ckpt: {len(state)} tensors, every "
            f"floating one f32")


def phase_main_path(cuda_build, spmm_cuda, gat_cuda, workdir: str, host,
                    g) -> dict:
    cfg = os.path.join(workdir, "arxiv.conf.yaml")
    _config_yaml(cfg)
    common = common_args(cfg, workdir)
    modules = (cuda_build, spmm_cuda, gat_cuda)
    sage = drive_path("SAGE", workdir, common, modules)
    for name in ("spmm_csr_bf16", "spmm_csr_int8"):
        if sage[name] == 0:
            raise AssertionError(f"{name} never launched on the SAGE path")
    gat = drive_path("GAT", workdir, common, modules)
    check_gat("GAT", gat, gat_counts(TEACHER_EPOCHS, 1))
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
        paths[teacher] = drive_path(teacher, workdir, common, modules)
        check_counts(teacher, paths[teacher], launched)

    # the inductive setting: training on the observed graph, every eval on
    # the observed and the full graph; sampled SAGE trains on no kernel
    ind = ["--exp_setting", "ind", "--split_rate", str(SPLIT_RATE)]
    sub = f"inductive/split_rate_{SPLIT_RATE}"
    paths["SAGE ind"] = drive_path("SAGE", workdir, common, modules, ind, sub)
    check_counts("SAGE ind", paths["SAGE ind"], {
        "spmm_csr_int8": len(WIDTHS) * TEACHER_EPOCHS * 2,
        "spmm_csr_bf16": len(WIDTHS) * 2})
    paths["GAT ind"] = drive_path("GAT", workdir, common, modules, ind, sub)
    check_gat("GAT ind", paths["GAT ind"], gat_counts(TEACHER_EPOCHS, 2))
    with open(os.path.join(run_dir(workdir, sub, "SAGE"), "log")) as f:
        want = f"Observed graph: {N_OBS} nodes"
        if want not in f.read():
            raise AssertionError(f"the SAGE ind log lacks {want!r}")

    # GCN with the propagated features (both CLIs: AUG_K hops of the f32
    # kernel each), the min-cut loss and the saved results
    aug = ["--feature_aug_k", str(AUG_K), "--compute_min_cut",
           "--save_results"]
    aug_sub = f"aug_features/aug_hop_{AUG_K}/transductive"
    names = (f"GA{AUG_K}GCN", f"GCN_GA{AUG_K}MLP")
    paths["GCN aug"] = drive_path("GCN", workdir, common, modules, aug,
                                  aug_sub, names)
    # GA2GCN finds no config row (the reference's quirk): hidden 128 from
    # the defaults and no dropout. Layer 1 then sums its 128 input
    # features before W, and they need no gradient: one transposed walk
    # per step, not two
    check_counts("GCN aug", paths["GCN aug"], {
        "spmm_csr_bf16": len(GCN_WIDTHS) * (TEACHER_EPOCHS + 1)
        + TEACHER_EPOCHS,
        "spmm_csr_int8": len(GCN_WIDTHS) * TEACHER_EPOCHS,
        "spmm_csr_f32": 2 * AUG_K})
    check_saved(workdir, cfg, aug_sub, names, host, g)

    # the window sampler tier with the aligned table and bf16 compute: the
    # sampled training runs no kernel; every eval's aggregations take bf16
    # x (int8 in the 3 intermediate evals, exact in the final one)
    wdir = os.path.join(workdir, "window_bf16")
    paths["SAGE window bf16"] = drive_path(
        "SAGE", wdir, common_args(cfg, wdir), modules, WINDOW_BF16)
    check_counts("SAGE window bf16", paths["SAGE window bf16"], {
        "spmm_csr_int8": len(WIDTHS) * TEACHER_EPOCHS,
        "spmm_csr_bf16": len(WIDTHS)})
    check_window_bf16(wdir)
    # one hub plan per CSR a path walks on the card, however many calls
    # walk it: the forward CSR of each graph an eval or a forward runs on,
    # and the transposed CSR of the graph a backward runs on (the sampled
    # SAGE training walks neither; a student CLI builds its own graph only
    # for feature_prop)
    plans = {"SAGE": 1, "GAT": 2, "GCN": 2, "APPNP": 2, "SAGE ind": 2,
             "GAT ind": 3, "GCN aug": 3, "SAGE window bf16": 1}
    built = {tag: PLAN_BUILDS[" ".join([teacher, *extra])] for tag, (
        teacher, extra) in {"SAGE": ("SAGE", ()), "GAT": ("GAT", ()),
                            "GCN": ("GCN", ()), "APPNP": ("APPNP", ()),
                            "SAGE ind": ("SAGE", ind), "GAT ind": ("GAT", ind),
                            "GCN aug": ("GCN", aug),
                            "SAGE window bf16": ("SAGE", WINDOW_BF16)}.items()}
    if built != plans:
        raise AssertionError(f"hub plans built per path {built}, expected one "
                             f"per CSR walked: {plans}")
    log(f"hub plans built per path: {built} (one per CSR walked)")
    return paths


# ---------------------------------------------------------------------------
# Phase 4c: --n_shards 4, four ranks sharing the card over gloo. The
# per-shard kernel checks and times, then the sharded paths through the
# CLIs; each path's launches are summed over its ranks (fresh processes,
# every count 0 at their start) in the run's log.
# ---------------------------------------------------------------------------

N_SHARDS = 4
DIST_WIDTHS = (128, 256)     # F of the per-shard checks (SAGE's layers)
HALO_HUB = (0, 1, 33, 1000, 20000)   # in-degrees of the hub case's rows


def dist_rank_checks(mesh, payload) -> dict | None:
    """On each rank: the exact kernel's local and halo partials and both
    transposes against the plain version at DIST_WIDTHS, each part timed
    (the exchange with every rank in step); the gathered halo_copy_u_sum
    against the single-device kernel sum on rank 0. Rank 0 returns every
    rank's numbers."""
    from glnn_tpu_torch.distributed import mesh as dmesh
    from glnn_tpu_torch.distributed.halo import halo_copy_u_sum
    from glnn_tpu_torch.ops import spmm_cuda

    started = time.time()
    dev = mesh.device
    hg = payload["shard"].to(dev)
    mine = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
            "started": started,
            "rows": hg.rows, "local_edges": int(hg.indices.shape[0]),
            "halo_edges": int(hg.halo_indices.shape[0]),
            "halo_rows": hg.n_recv, "max_abs_err": 0.0, "ms": {}}
    for f in DIST_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(f)
        x_all = torch.randn((hg.n_pad, f), generator=gen, device=dev)
        x = x_all[mesh.rank * hg.rows:(mesh.rank + 1) * hg.rows].contiguous()
        dout = spmm_cuda.to_message(torch.randn((hg.rows, f), generator=gen,
                                                device=dev))
        send = x.index_select(0, hg.send_idx)

        def exchange():
            return dmesh.all_to_all(send, hg.send_splits, hg.recv_splits)

        recv = spmm_cuda.to_message(exchange())
        xb = spmm_cuda.to_message(x)
        parts = {"local": ("indptr", xb, hg.rows),
                 "halo": ("halo_indptr", recv, hg.rows),
                 "local transpose": ("t_indptr", dout, hg.rows),
                 "halo transpose": ("halo_t_indptr", dout, hg.n_recv)}
        for part, (csr, xin, n_rows) in parts.items():
            args = (getattr(hg, csr),
                    getattr(hg, csr.replace("indptr", "indices")), xin,
                    n_rows)
            plan = spmm_cuda.plan_of(hg, csr, n_rows)    # kept on the shard
            got = spmm_cuda.csr_sum_bf16(*args, plan)
            want = spmm_cuda.plain_csr_sum_bf16(*args)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            err = (got - want).abs().max().item() if got.numel() else 0.0
            mine["max_abs_err"] = max(mine["max_abs_err"], err)
            mine["ms"][f"{part} F={f}"] = time_ms(
                lambda a=args, p=plan: spmm_cuda.csr_sum_bf16(*a, p))
        torch.distributed.barrier()
        mine["ms"][f"exchange F={f}"] = time_ms(exchange)
        out = dmesh.all_gather_rows(halo_copy_u_sum(hg, x))[:hg.n_nodes]
        if mesh.rank == 0:
            g = payload["graph"].to(dev)
            want = spmm_cuda.copy_u_sum(g, x_all[:hg.n_nodes])
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
            mine[f"gathered vs single-device F={f}"] = (
                out - want).abs().max().item()
        del x_all, out
    halo_attention_checks(mesh, hg, payload, mine)
    places = [None] * mesh.size
    torch.distributed.all_gather_object(places, mine)
    return places if mesh.rank == 0 else None


def _exchange_back(hg, dsrc):
    """dsrc [rows + n_recv, ...] -> [rows, ...]: the receive rows' part sent
    home and added at the send rows (the halo ops' reverse exchange)."""
    from glnn_tpu_torch.distributed import mesh as dmesh

    rows = hg.rows
    back = dmesh.all_to_all(dsrc[rows:].contiguous(), hg.recv_splits,
                            hg.send_splits)
    return dsrc[:rows].clone().index_add_(0, hg.send_idx, back)


def halo_plain_wsum(hg, x, w, dout):
    """(out, dX, dW) of the halo weighted sum through the plain versions:
    the exchange, plain_csr_wsum_bf16 over the combined CSR and over its
    transpose, the reverse exchange, dW = <src, dH[dst]> in f32."""
    from glnn_tpu_torch.distributed.halo import source_table
    from glnn_tpu_torch.ops import spmm_cuda

    rows, n_src = hg.rows, hg.rows + hg.n_recv
    heads = 1 if w.dim() == 1 else w.shape[1]
    src = source_table(hg, x).reshape(n_src, -1)
    d2 = dout.reshape(rows, -1)
    out = spmm_cuda.plain_csr_wsum_bf16(hg.c_indptr, hg.c_indices, None,
                                        src, w, rows)
    dsrc = spmm_cuda.plain_csr_wsum_bf16(hg.c_t_indptr, hg.c_t_dst,
                                         hg.c_t_edges, d2, w, n_src)
    e = hg.n_edges
    dw = (src[hg.c_indices.long()].view(e, heads, -1)
          * d2[hg.c_dst.long()].view(e, heads, -1)).sum(-1)
    return (out.view(x.shape), _exchange_back(hg, dsrc).view(x.shape),
            dw.view(w.shape))


def halo_plain_gat(hg, feat, al, ar, seed, dout):
    """(out, dfeat, dattn_l, dattn_r) of the fused halo GAT layer through
    the plain versions of gat_fwd, gat_bwd and the source reduce, from the
    same gat_prep outputs as the layer (phase 2 holds gat_prep itself; a
    plain prep's er may round to the neighbouring bf16 value and move a
    score): the exchange of the bf16 features and el, plain_gat_fwd /
    plain_gat_bwd with philox_keep's mask at the shard's edge_base, the
    message summed over the sources, the reverse exchange."""
    from glnn_tpu_torch.distributed.halo import source_table
    from glnn_tpu_torch.ops import gat_cuda

    rows, (_, h, d) = hg.rows, feat.shape
    inv_keep = 1.0 / (1.0 - ATTN_DROP)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    src_b = source_table(hg, feat_b.view(rows, -1)).view(-1, h, d)
    keep = gat_cuda.philox_keep(seed, hg.n_edges, h, 1.0 - ATTN_DROP,
                                hg.edge_base)
    args = (hg.c_indptr, hg.c_indices, src_b, source_table(hg, el), er_b,
            keep, inv_keep, 0.2)
    out, smax, denom = gat_cuda.plain_gat_fwd(*args)
    der, msg, dal = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
    dsrc = torch.zeros((src_b.shape[0], h, d), device=feat.device).index_add_(
        0, hg.c_indices, msg.float())
    dfeat = _exchange_back(hg, dsrc) + der[:, :, None] * ar[None]
    return out, dfeat, dal, torch.einsum("nh,nhd->hd", der, feat)


def halo_attention_checks(mesh, hg, payload, mine) -> None:
    """On each rank, the per-edge halo ops against their plain versions on
    the card: the fused halo GAT layer at both GAT shapes in seed mode
    (forward and one backward), the halo softmax on [E_p, 8] and [E_p, 1],
    the halo weighted sum scalar at F = 40 with APPNP's {0, 2} weights and
    per head at (8, 16) (forward, dX, dW); the per-op halo GAT layer
    against the fused one, its launches counted; the gathered fused layer
    against the single-device layer with the same seed on rank 0; and the
    exchange against the kernels of one halo GAT layer and one APPNP hop,
    timed."""
    from glnn_tpu_torch import ops
    from glnn_tpu_torch.distributed import mesh as dmesh
    from glnn_tpu_torch.distributed.halo import (halo_edge_softmax,
                                                 halo_gat_attention,
                                                 halo_u_mul_e_sum)
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    dev, rows, r = mesh.device, hg.rows, mesh.rank
    e_p = hg.n_edges
    inv_keep = 1.0 / (1.0 - ATTN_DROP)
    errs = mine.setdefault("halo_errs", {})

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    def mine_of(t):
        return t[r * rows:(r + 1) * rows].contiguous()

    mine["edges"] = e_p
    # the fused halo GAT layer, seed mode, against the plain chain
    layers = {}
    for h, d in GAT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(300 + h * d)
        feat_all = torch.randn((hg.n_pad, h, d), generator=gen, device=dev)
        al, ar = (0.3 * torch.randn((h, d), generator=gen, device=dev)
                  for _ in range(2))
        seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                             generator=gen, device=dev)
        dout = mine_of(torch.randn((hg.n_pad, h, d), generator=gen,
                                   device=dev))
        feat = mine_of(feat_all)
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        out = halo_gat_attention(hg, *leaves, 0.2, seed, inv_keep)
        out.backward(dout)
        want = halo_plain_gat(hg, feat, al, ar, seed, dout)
        torch.cuda.synchronize()
        tag = f"halo GAT ({h}, {d})"
        note("gat_fwd", _held(f"{tag} out", out, want[0], 1e-4, 1e-4))
        note("gat_bwd dfeat", _held(f"{tag} dfeat", leaves[0].grad, want[1],
                                    1e-2, 1e-2))
        note("gat_bwd dattn", max(
            _held(f"{tag} dattn_l", leaves[1].grad, want[2], 1e-4, 1e-4),
            _held(f"{tag} dattn_r", leaves[2].grad, want[3], 1e-4, 1e-4)))
        layers[(h, d)] = (feat, al, ar, seed, dout, out.detach())
        # the gathered layer against the single-device layer, same seed
        got = dmesh.all_gather_rows(out.detach())[:hg.n_nodes]
        if r == 0:
            g = payload["graph"].to(dev)
            single = gat_cuda.gat_attention(g, feat_all[:hg.n_nodes], al, ar,
                                            0.2, seed, inv_keep)
            torch.cuda.synchronize()
            mine[f"gathered GAT ({h}, {d}) vs single-device"] = _held(
                f"{tag} gathered vs single-device", got, single, 1e-4, 1e-4)
            del g, single
        del leaves, want, got, feat_all
    # the segment softmax over the shard's rows
    for h in (8, 1):
        gen = torch.Generator(device=dev).manual_seed(400 + h + r)
        s = (3 * torch.randn((e_p, h), generator=gen, device=dev)
             ).requires_grad_(True)
        da = torch.randn((e_p, h), generator=gen, device=dev)
        alpha = halo_edge_softmax(hg, s, kernel=True)
        alpha.backward(da)
        w_alpha = gat_cuda.plain_edge_softmax_fwd(hg.c_indptr, s.detach(),
                                                  rows)
        w_ds = gat_cuda.plain_edge_softmax_bwd(hg.c_indptr, w_alpha, da, rows)
        torch.cuda.synchronize()
        note("edge_softmax_fwd", _held(f"halo softmax [E_p, {h}]", alpha,
                                       w_alpha, 1e-5, 1e-6))
        note("edge_softmax_bwd", _held(f"halo softmax grad [E_p, {h}]",
                                       s.grad, w_ds, 1e-4, 1e-6))
    # the weighted sum: APPNP's hop and the per-head GAT shape
    gen = torch.Generator(device=dev).manual_seed(500)
    wcases = (("F=40 keep weights {0, 2}",
               torch.randn((hg.n_pad, APPNP_F), generator=gen, device=dev),
               None),
              ("(8, 16) softmax-like weights",
               torch.randn((hg.n_pad, 8, 16), generator=gen, device=dev), 8))
    for tag, x_all, heads in wcases:
        wgen = torch.Generator(device=dev).manual_seed(600 + r)
        if heads is None:
            w = (torch.rand(e_p, generator=wgen, device=dev)
                 >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
        else:
            w = torch.rand((e_p, heads), generator=wgen, device=dev) / 8
        x = mine_of(x_all)
        dout = torch.randn_like(x)
        leaves = [t.clone().requires_grad_(True) for t in (x, w)]
        out = halo_u_mul_e_sum(hg, *leaves, kernel=True)
        out.backward(dout)
        want = halo_plain_wsum(hg, x, w, dout)
        torch.cuda.synchronize()
        note("spmm_csr_weighted", max(
            _held(f"halo wsum {tag} out", out, want[0], 1e-5, 1e-4),
            _held(f"halo wsum {tag} dX", leaves[0].grad, want[1], 1e-5, 1e-4),
            _held(f"halo wsum {tag} dW", leaves[1].grad, want[2], 1e-5,
                  1e-4)))
        del leaves, want, x_all
    # the per-op halo GAT layer (the only caller of the softmax kernels on
    # a shard), counts set to 0 before and read after, against the fused
    modules = (cuda_build, spmm_cuda, gat_cuda)
    inputs = [(feat, al, ar, gat_cuda.philox_keep(
        seed, e_p, h, 1.0 - ATTN_DROP, hg.edge_base), dout, fused)
        for (h, _), (feat, al, ar, seed, dout, fused) in layers.items()]
    torch.distributed.barrier()
    for module in modules:
        module.reset_counts()
    outs = []
    for feat, al, ar, keep, dout, _ in inputs:
        leaves = [t.clone().requires_grad_(True) for t in (feat, al, ar)]
        out = per_op_layer(ops, hg, *leaves, keep, ops.edge_softmax,
                           ops.u_mul_e_sum)
        out.backward(dout)
        outs.append(out.detach())
    torch.cuda.synchronize()
    mine["per_op_counts"] = {k: v for m in modules
                             for k, v in m.counts.items()}
    for (feat, *_, fused), out in zip(inputs, outs):
        note("per-op vs fused", _held(
            f"halo per-op layer {tuple(feat.shape[1:])} vs fused", out,
            fused, 2e-2, 1e-2))
    del inputs, outs, layers
    mine["ms"].update(halo_layer_times(hg, mesh))


def halo_layer_times(hg, mesh) -> dict:
    """Per rank: the exchange against the kernels of one halo GAT layer at
    (8, 16) (forward and backward) and of one APPNP hop at F = 40 (forward
    and dX), each timed alone with every rank in step."""
    from glnn_tpu_torch.distributed import mesh as dmesh
    from glnn_tpu_torch.distributed.halo import source_table
    from glnn_tpu_torch.ops import gat_cuda, spmm_cuda

    dev, rows, n_src = mesh.device, hg.rows, hg.rows + hg.n_recv
    gen = torch.Generator(device=dev).manual_seed(700)
    h, d = GAT_SHAPES[0]
    feat = torch.randn((rows, h, d), generator=gen, device=dev)
    al, ar = (0.3 * torch.randn((h, d), generator=gen, device=dev)
              for _ in range(2))
    seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64, generator=gen,
                         device=dev)
    inv_keep = 1.0 / (1.0 - ATTN_DROP)
    feat_b, el, er_b, al_b = gat_cuda.prep(feat, al, ar)
    packed = torch.cat([feat_b.view(rows, -1), el.view(torch.bfloat16)], 1)
    send = packed.index_select(0, hg.send_idx)
    fwd = (hg.c_indptr, hg.c_indices,
           source_table(hg, feat_b.view(rows, -1)).view(-1, h, d),
           source_table(hg, el), er_b, seed, inv_keep, 0.2)
    # the shard's kept hub plans of its combined CSR (the GAT layer's and
    # the weighted sum's) and transpose
    plan = spmm_cuda.plan_of(hg, "c_indptr", rows)
    gat_plan = spmm_cuda.plan_of(hg, "c_indptr", rows, gat_cuda.GAT_CHUNK)
    t_plan = spmm_cuda.plan_of(hg, "c_t_indptr", n_src)
    _, smax, denom = gat_cuda.gat_fwd(*fwd, edge_base=hg.edge_base,
                                      plan=gat_plan)
    dout = torch.randn((rows, h, d), generator=gen, device=dev)
    _, msg, _ = gat_cuda.gat_bwd(*fwd, smax, denom, dout, al_b,
                                 hg.edge_base, gat_plan)
    dsrc = spmm_cuda.csr_sum_bf16(hg.c_t_indptr, hg.c_t_edges,
                                  msg.view(-1, h * d), n_src, t_plan)
    x = torch.randn((rows, APPNP_F), generator=gen, device=dev)
    w = (torch.rand(hg.n_edges, generator=gen, device=dev) >= EDGE_DROP
         ).float() * 2
    xsrc = source_table(hg, x)
    dh = torch.randn((rows, APPNP_F), generator=gen, device=dev)
    kernels = {
        "GAT (8, 16) gat_prep": lambda: gat_cuda.prep(feat, al, ar),
        "GAT (8, 16) gat_fwd": lambda: gat_cuda.gat_fwd(
            *fwd, edge_base=hg.edge_base, plan=gat_plan),
        "GAT (8, 16) gat_bwd": lambda: gat_cuda.gat_bwd(
            *fwd, smax, denom, dout, al_b, hg.edge_base, gat_plan),
        "GAT (8, 16) source reduce": lambda: spmm_cuda.csr_sum_bf16(
            hg.c_t_indptr, hg.c_t_edges, msg.view(-1, h * d), n_src, t_plan),
        "APPNP hop F=40 forward": lambda: spmm_cuda.csr_wsum_bf16(
            hg.c_indptr, hg.c_indices, None, xsrc, w, rows, plan),
        "APPNP hop F=40 dX": lambda: spmm_cuda.csr_wsum_bf16(
            hg.c_t_indptr, hg.c_t_dst, hg.c_t_edges, dh, w, n_src, t_plan)}
    exchanges = {
        "GAT (8, 16) exchange (bf16 features and el)":
            lambda: dmesh.all_to_all(send, hg.send_splits, hg.recv_splits),
        "GAT (8, 16) reverse exchange (f32 dfeat)":
            lambda: dmesh.all_to_all(dsrc[rows:], hg.recv_splits,
                                     hg.send_splits),
        "APPNP hop F=40 exchange (f32)":
            lambda: dmesh.all_to_all(x.index_select(0, hg.send_idx),
                                     hg.send_splits, hg.recv_splits),
        "APPNP hop F=40 reverse exchange (f32)":
            lambda: dmesh.all_to_all(xsrc[rows:], hg.recv_splits,
                                     hg.send_splits)}
    ms = {k: time_ms(fn) for k, fn in kernels.items()}
    for k, fn in exchanges.items():
        torch.distributed.barrier()
        ms[k] = time_ms(fn)
    return ms


def check_rect_hub(spmm_cuda, dev) -> float:
    """A halo-shaped CSR: 42,336 dst rows (a shard) over a receive buffer of
    60,000 rows, the first rows with HALO_HUB in-edges, at F = 40."""
    rs = np.random.RandomState(DATA_SEED)
    n_rows, n_src, k = 42336, 60000, len(HALO_HUB)
    rows = np.concatenate([np.repeat(np.arange(k), HALO_HUB),
                           rs.randint(k, n_rows, 600000)])
    rows.sort(kind="stable")
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    indptr = torch.as_tensor(indptr.astype(np.int32), device=dev)
    cols = torch.as_tensor(rs.randint(0, n_src, rows.shape[0]).astype(
        np.int32), device=dev)
    xb = spmm_cuda.to_message(torch.randn((n_src, 40), device=dev))
    got = spmm_cuda.csr_sum_bf16(indptr, cols, xb, n_rows)
    want = spmm_cuda.plain_csr_sum_bf16(indptr, cols, xb, n_rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    err = (got - want).abs().max().item()
    log(f"check rectangular hub CSR ({n_rows} rows over {n_src}, rows of "
        f"{HALO_HUB} edges) F=40: exact kernel vs plain max|err| {err:.3e}")
    return err


def check_label_propagation(host, card: str) -> dict:
    """label_propagation_labels on the smoke graph on the native tier, bit
    for bit against the numpy tier, both timed."""
    from glnn_tpu_torch import native
    from glnn_tpu_torch.distributed.partition import label_propagation_labels

    n = host.num_nodes()
    native.reset_counts()
    t0 = time.perf_counter()
    got = label_propagation_labels(host.src, host.dst, n)
    t1 = time.perf_counter()
    available = native.available
    native.available = lambda: False
    try:
        want = label_propagation_labels(host.src, host.dst, n)
    finally:
        native.available = available
    t2 = time.perf_counter()
    if native.counts["label_propagation"] != 1:
        raise AssertionError(f"the native sweep ran "
                             f"{native.counts['label_propagation']} times")
    if not np.array_equal(got, want):
        raise AssertionError("native label propagation differs from the "
                             "numpy tier on the smoke graph")
    rec = dict(native_s=t1 - t0, numpy_s=t2 - t1,
               communities=int(np.unique(got).size))
    log(f"check label propagation on the smoke graph ({host.num_edges():,} "
        f"edges): native equal to the numpy tier, {rec['communities']:,} "
        f"communities; native {rec['native_s']:.2f} s, numpy "
        f"{rec['numpy_s']:.2f} s (host seconds); {card}")
    return rec


def phase_dist_checks(spmm_cuda, host, dev, card: str,
                      device: str = "cuda:0") -> dict:
    """The relabelled smoke graph in N_SHARDS shards, the checks on 4 ranks
    sharing the card (each rank on `device`), and the rectangular hub
    case."""
    from glnn_tpu_torch.cli.sharded import locality_relabel
    from glnn_tpu_torch.distributed import mesh as dmesh
    from glnn_tpu_torch.distributed.halo import build_halo_graph

    label_prop = check_label_propagation(host, card)
    t0 = time.perf_counter()
    quiet = logging.getLogger("chip_smoke.relabel")
    relabelled = locality_relabel(host, np.zeros((host.num_nodes(), 1)),
                                  np.zeros(host.num_nodes()), (), N_SHARDS,
                                  quiet)[0]
    shards = build_halo_graph(relabelled.src, relabelled.dst,
                              relabelled.num_nodes(), N_SHARDS, combined=True)
    frac = sum(s.halo_indices.shape[0] for s in shards) / host.num_edges()
    log(f"distributed: relabel and halo sets {time.perf_counter() - t0:.2f} "
        f"host s; halo edge fraction {frac:.4f} at P={N_SHARDS}")
    graph = relabelled.to_device("cpu")
    payloads = [{"shard": s, "graph": graph if r == 0 else None}
                for r, s in enumerate(shards)]
    launched = time.time()
    ranks = dmesh.launch(dist_rank_checks, payloads, 0, timeout=600)
    log(f"distributed: {N_SHARDS} ranks reached their function "
        + ", ".join(f"{r['started'] - launched:.2f}" for r in ranks)
        + f" s after the launch (host clock); {card}")
    for r in ranks:
        if (r["backend"], r["device"]) != ("gloo", device):
            raise AssertionError(f"rank {r['rank']} ran on {r['backend']} "
                                 f"{r['device']}")
        log(f"rank {r['rank']}: {r['backend']} on {r['device']}; "
            f"{r['rows']} rows, {r['local_edges']} local and "
            f"{r['halo_edges']} halo edges, {r['halo_rows']} halo rows "
            f"({r['halo_rows'] * 4 * WIDTHS[0] / 1e6:.2f} MB at F = 128 f32 "
            f"a layer); max|err| {r['max_abs_err']:.3e}; ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items())
            + f"; {card}")
    for f in DIST_WIDTHS:
        log(f"gathered halo_copy_u_sum vs single-device kernel F={f}: "
            f"max|err| {ranks[0][f'gathered vs single-device F={f}']:.3e}")
    halo_errs = {k: max(r["halo_errs"][k] for r in ranks)
                 for k in ranks[0]["halo_errs"]}
    log(f"per-edge halo ops vs their plain versions on {N_SHARDS} ranks "
        f"({', '.join(str(r['edges']) for r in ranks)} edges a shard): "
        f"max|err| {halo_errs}")
    for h, d in GAT_SHAPES:
        key = f"gathered GAT ({h}, {d}) vs single-device"
        log(f"gathered halo GAT layer ({h}, {d}), seed mode, vs the "
            f"single-device layer with the same seed: max|err| "
            f"{ranks[0][key]:.3e}")
    per_op = {k: sum(r["per_op_counts"][k] for r in ranks)
              for k in ranks[0]["per_op_counts"]}
    layers = len(GAT_SHAPES)
    check_counts("per-op halo GAT layer", per_op, {
        "edge_softmax_fwd": N_SHARDS * layers,
        "edge_softmax_bwd": N_SHARDS * layers,
        "spmm_csr_weighted": 2 * N_SHARDS * layers}
        if device.startswith("cuda") else {})
    log(f"per-op halo GAT layer: launches summed over the ranks {per_op}")
    return {"halo_edge_fraction": frac, "label_propagation": label_prop,
            "ranks": ranks,
            "halo_errs": halo_errs, "per_op_counts": per_op,
            "rect_hub_f40": check_rect_hub(spmm_cuda, dev), "card": card}


def sharded_counts(tag: str, log_path: str, device: str) -> dict:
    """The run's log: every rank on `device` over gloo, and its launches
    line (summed over the ranks)."""
    with open(log_path) as f:
        text = f.read()
    for r in range(N_SHARDS):
        want = f"rank {r} of {N_SHARDS}: backend gloo, device {device}"
        if want not in text:
            raise AssertionError(f"the {tag} log lacks {want!r}")
    lines = [line for line in text.splitlines() if ": launches {" in line]
    if len(lines) != 1:
        raise AssertionError(f"the {tag} log has {len(lines)} launches lines")
    for line in text.splitlines():
        if any(k in line for k in ("halo graph", "halo observed",
                                   "relabel", "mean epoch time")):
            log(f"  {tag} log: {line.split(': ', 1)[1].strip()}")
    return json.loads(lines[0].split("launches ", 1)[1])


def drive_sharded(tag, workdir, common, model, extra=(), sub="transductive",
                  student=False, device="cuda:0",
                  epochs=TEACHER_EPOCHS) -> tuple:
    """One CLI run with --n_shards N_SHARDS (the teacher for `epochs`
    epochs, or with `student` an MLP student of the teacher `model`): its
    score line, out.npz and the summed launches from its log; returns
    (counts, seconds)."""
    from glnn_tpu_torch import native
    from glnn_tpu_torch.cli import train_student, train_teacher

    name = f"{model}_MLP" if student else model
    printed = io.StringIO()
    native.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        if student:
            train_student.main(common + [
                "--teacher", model, "--student", "MLP", "--max_epoch",
                str(STUDENT_EPOCHS), "--n_shards", str(N_SHARDS),
                "--out_t_path", os.path.join(workdir, "outputs"), *extra])
        else:
            train_teacher.main(common + [
                "--teacher", model, "--max_epoch", str(epochs),
                "--n_shards", str(N_SHARDS), *extra])
    seconds = time.perf_counter() - t0
    score = printed.getvalue().strip()
    print(score)
    n_scores = 2 if "ind" in extra else 1
    if (len(score.split()) != n_scores
            or not all(math.isfinite(float(s)) for s in score.split())):
        raise AssertionError(f"{tag} printed no line of {n_scores} finite "
                             f"scores: {score!r}")
    path = run_dir(workdir, sub, name, DATASET)
    check_out(os.path.join(path, "out.npz"), tag, (N_NODES, N_CLASSES))
    counts = sharded_counts(tag, os.path.join(path, "log"), device)
    log(f"{tag} path: {seconds:.2f} s; launches summed over the ranks "
        f"{counts}; host graph ops {native.counts}")
    check_native_tier(tag, os.path.join(path, "log"))
    # a GNN teacher relabels its graph once and sorts its shards' CSRs; the
    # MLP student builds no CSR
    want = ({"label_propagation": 1} if not student
            else {"sort_edges": 0, "label_propagation": 0})
    if (any(native.counts[k] != v for k, v in want.items())
            or (not student and not native.counts["sort_edges"])):
        raise AssertionError(f"{tag}: host graph ops {native.counts}, "
                             f"predicted {want} (and a sort for a teacher)")
    if not student:
        with open(os.path.join(path, "log")) as f:
            if "locality relabel: native label propagation" not in f.read():
                raise AssertionError(f"{tag}: the relabel did not run on the "
                                     f"native tier")
    if counts["plain_on_cuda"]:
        raise AssertionError(f"{counts['plain_on_cuda']} plain-version calls "
                             f"on CUDA tensors on the {tag} path")
    return counts, seconds


def check_sharded_eval(workdir: str, cfg: str, host, g,
                       teacher: str = "SAGE") -> float:
    """A sharded teacher's out.npz (its halo all-node exact eval, in the
    original node order) against the single-device kernel eval of its
    saved weights on the original graph: the same bf16 messages (SAGE),
    or the same bf16 features and f32 softmax (GAT; the same keep bits do
    not enter an eval), summed in another order and through every layer
    (rtol 1e-4 / atol 1e-4)."""
    from glnn_tpu_torch.cli import train_teacher
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import make_eval_fn
    from glnn_tpu_torch.utils import get_training_config, load_model
    from glnn_tpu_torch.utils.config import merge_args_with_config

    path = run_dir(workdir, "transductive", teacher, DATASET)
    conf = merge_args_with_config(
        dict(vars(train_teacher.get_args([])), feat_dim=WIDTHS[0],
             label_dim=N_CLASSES),
        get_training_config(cfg, teacher, DATASET))
    model = Model(conf).to(g.device)
    model.load_state_dict(load_model(os.path.join(path, "model.ckpt")))
    feats = torch.as_tensor(host.ndata["feat"], device=g.device)
    got = make_eval_fn(model, exact=True)(g, feats).cpu().numpy()
    want = np.load(os.path.join(path, "out.npz"))["arr_0"]
    np.testing.assert_allclose(want, got, rtol=1e-4, atol=1e-4,
                               err_msg=f"sharded {teacher} eval vs "
                                       f"single-device")
    err = float(np.abs(want - got).max())
    log(f"sharded {teacher} teacher: its halo eval (out.npz) vs the "
        f"single-device kernel eval of model.ckpt max|err| {err:.3e}, argmax "
        f"equal on {(want.argmax(1) == got.argmax(1)).mean():.4%} of rows")
    return err


def sharded_launches(evals: int, graphs: int, steps: int, layers: int) -> int:
    """spmm_csr_bf16 launches summed over the ranks of a halo path: two
    partials a layer on every rank, forward in each training step and eval
    (`evals` intermediate evals and the final one, on `graphs` graphs), the
    two transposes in each step's backward."""
    return N_SHARDS * 2 * layers * (2 * steps + graphs * (evals + 1))


def sharded_gat_launches(evals: int, graphs: int) -> dict:
    """A halo GAT path's launches summed over the ranks: gat_prep and
    gat_fwd per layer in each training step and eval (`evals` and the
    final one, on `graphs` graphs), gat_bwd and its SpMM source reduce per
    layer in each step, every training launch in seed mode."""
    layers, steps = len(GAT_SHAPES), TEACHER_EPOCHS
    forwards = N_SHARDS * layers * (steps + graphs * (evals + 1))
    backwards = N_SHARDS * layers * steps
    return {"gat_prep": forwards, "gat_fwd": forwards, "gat_bwd": backwards,
            "gat_fwd_seed": backwards, "gat_bwd_seed": backwards,
            "spmm_csr_bf16": backwards}


def sharded_appnp_launches(evals: int, graphs: int) -> dict:
    """A halo APPNP path's launches summed over the ranks: the weighted
    sum's forward and dX per hop in each training step (edge drop), and
    halo_copy_u_sum's two exact partials per hop in each eval."""
    return {"spmm_csr_weighted": N_SHARDS * 2 * APPNP_HOPS * TEACHER_EPOCHS,
            "spmm_csr_bf16": sharded_launches(evals, graphs, 0, APPNP_HOPS)}


def phase_dist_paths(workdir: str, cfg: str, host, g, common: list,
                     on_card: bool = True) -> dict:
    """SAGE (sampled, data-parallel; its evals on the halo graph) with
    --save_results then the data-parallel MLP student, tran; GCN (halo)
    tran and ind; GAT (halo, the published row) tran with --save_results;
    APPNP (halo, the synth row) tran and ind. The launches summed over the
    ranks exactly as worked out from the code (all 0 off the card, where
    the plain versions run)."""
    device = "cuda:0" if on_card else "cpu"
    ind = ["--exp_setting", "ind", "--split_rate", str(SPLIT_RATE)]
    sub = f"inductive/split_rate_{SPLIT_RATE}"
    runs = {}
    cut = SHARD_CUT_EPOCHS
    for tag, model, extra, sub_, student, epochs, want in (
            ("SAGE n_shards 4", "SAGE", ["--save_results"], "transductive",
             False, cut, {"spmm_csr_bf16": sharded_launches(
                 cut, 1, 0, len(WIDTHS))}),
            ("SAGE MLP n_shards 4", "SAGE", [], "transductive", True,
             TEACHER_EPOCHS, {}),
            ("GCN n_shards 4", "GCN", [], "transductive", False, cut,
             {"spmm_csr_bf16": sharded_launches(
                 cut, 1, cut, len(GCN_WIDTHS))}),
            ("GCN ind n_shards 4", "GCN", ind, sub, False, cut,
             {"spmm_csr_bf16": sharded_launches(
                 cut, 2, cut, len(GCN_WIDTHS))}),
            ("GAT n_shards 4", "GAT", ["--save_results"], "transductive",
             False, TEACHER_EPOCHS, sharded_gat_launches(TEACHER_EPOCHS, 1)),
            ("APPNP n_shards 4", "APPNP", [], "transductive", False,
             TEACHER_EPOCHS, sharded_appnp_launches(TEACHER_EPOCHS, 1)),
            ("APPNP ind n_shards 4", "APPNP", ind, sub, False,
             TEACHER_EPOCHS, sharded_appnp_launches(TEACHER_EPOCHS, 2))):
        counts, seconds = drive_sharded(tag, workdir, common, model, extra,
                                        sub_, student, device, epochs)
        log(f"{tag}: launches predicted {want}")
        check_counts(tag, counts, want if on_card else {})
        runs[tag] = {"counts": counts, "seconds": seconds}
    runs["sharded_eval_max_abs_err"] = check_sharded_eval(workdir, cfg, host,
                                                          g)
    runs["sharded_gat_eval_max_abs_err"] = check_sharded_eval(
        workdir, cfg, host, g, "GAT")
    for model in ("SAGE", "GAT", "APPNP"):
        with open(os.path.join(run_dir(workdir, "transductive", model,
                                       DATASET), "log")) as f:
            epoch = [line for line in f if "mean epoch time" in line]
        runs[f"{model.lower()}_epoch"] = epoch[0].split(": ", 1)[1].strip()
    return runs


# ---------------------------------------------------------------------------
# Phase 4b: the dataset files. One file set per family at its published
# shape, with synthetic contents from DATA_SEED, in a temporary directory;
# each loaded through load_data and held against what was written; four
# paths driven through the CLIs with the package's own train.conf.yaml.
# ---------------------------------------------------------------------------

def write_cora(path: str, rs) -> dict:
    """cora in the CPF npz schema at its published shape: 2,708 nodes,
    1,433 binary bag-of-words features (a CSR attr, about 18 words a node,
    half of them from a block of the node's class), 7 classes; a connected
    core of CORA_LCC nodes (a random tree plus in-class edges, CORA_EDGES
    undirected edges in all) and the other nodes in paths of 2 and 3,
    which `standardize` drops. Edges stored one way, as the loader
    symmetrises them."""
    import scipy.sparse as sp

    from glnn_tpu_torch.graph import sparse as gsp

    n, f, c, core = CORA_NODES, CORA_FEATS, CORA_CLASSES, CORA_LCC
    labels = rs.randint(0, c, n)
    perm = rs.permutation(core)
    src = [perm[1:]]
    dst = [perm[(rs.rand(core - 1) * np.arange(1, core)).astype(np.int64)]]
    sizes, left = [], n - core
    while left:
        sizes.append(3 if left >= 5 or left == 3 else 2)
        left -= sizes[-1]
    start = core
    for size in sizes:
        src.append(np.arange(start, start + size - 1))
        dst.append(np.arange(start + 1, start + size))
        start += size
    extra = CORA_EDGES - sum(len(a) for a in src)
    es = rs.randint(0, core, extra)
    by_class = np.argsort(labels[:core], kind="stable")
    counts = np.bincount(labels[:core], minlength=c)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    mate = by_class[first[labels[es]]
                    + (rs.rand(extra) * counts[labels[es]]).astype(np.int64)]
    src.append(es)
    dst.append(np.where(rs.rand(extra) < 0.8, mate,
                        rs.randint(0, core, extra)))
    src, dst = np.concatenate(src), np.concatenate(dst)
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    words = np.where(rs.rand(n * 18) < 0.5,
                     np.repeat(labels, 18) * 200 + rs.randint(0, 200, n * 18),
                     rs.randint(0, f, n * 18))
    attr = sp.csr_matrix((np.ones(n * 18, np.float32),
                          (np.repeat(np.arange(n), 18), words)), shape=(n, f))
    attr.data[:] = 1.0                       # repeated words sum; binary
    gsp.save_npz_sparse_graph(os.path.join(path, "cora.npz"), adj, attr,
                              labels)
    return {"labels": labels, "attr": attr}


def check_cora(loaded, written) -> None:
    g, labels, itr, iva, ite = loaded
    core = CORA_LCC
    want = np.asarray(written["attr"][:core].todense(), np.float32)
    if (g.n_nodes != core or int((g.src == g.dst).sum()) != core
            or not np.array_equal(g.ndata["feat"], want)
            or not np.array_equal(labels, written["labels"][:core])
            or len(itr) != 20 * CORA_CLASSES or len(iva) != 30 * CORA_CLASSES
            or len(itr) + len(iva) + len(ite) != core):
        raise AssertionError("cora: the loader's output differs from the "
                             "file's core component")


def write_arxiv(path: str, rs, host, labels) -> dict:
    """ogbn-arxiv in the OGB npz form: one direction (src < dst) of each
    non-loop edge of the smoke graph, its 128 features and 40 classes, and
    OGB's split sizes over a permutation."""
    n = host.n_nodes
    one_way = host.src < host.dst
    perm = rs.permutation(n)
    a, b = ARXIV_SPLIT[0], ARXIV_SPLIT[0] + ARXIV_SPLIT[1]
    arrays = dict(src=host.src[one_way], dst=host.dst[one_way],
                  n_nodes=np.int64(n), feat=host.ndata["feat"],
                  labels=np.asarray(labels, np.int64), idx_train=perm[:a],
                  idx_val=perm[a:b], idx_test=perm[b:])
    np.savez(os.path.join(path, "ogbn-arxiv.graph.npz"), **arrays)
    return arrays


def check_arxiv(loaded, written, host) -> None:
    """The loader's reverse / remove / add self-loop rebuilds the smoke
    graph's edge multiset exactly."""
    g, labels, *idx = loaded
    n = host.n_nodes
    keys = np.sort(g.src * n + g.dst)
    if (g.num_edges() != host.num_edges()
            or not np.array_equal(keys, np.sort(host.src * n + host.dst))
            or not np.array_equal(g.ndata["feat"], written["feat"])
            or not np.array_equal(labels, written["labels"])
            or not all(np.array_equal(a, written[k]) for a, k in zip(
                idx, ("idx_train", "idx_val", "idx_test")))):
        raise AssertionError("ogbn-arxiv: the loader's output differs from "
                             "the smoke graph")
    log(f"ogbn-arxiv: the loader rebuilt the smoke graph's edge multiset, "
        f"{g.num_edges():,} edges")


def write_products(path: str, dev) -> dict:
    """ogbn-products in the OGB npz form at its published shape, built on
    the card: 2,449,029 nodes, 100 features (class centroid + noise), 47
    round-robin classes, PRODUCTS_PAIRS undirected planted-partition pairs
    (80% within the class, no self-loop) stored in both directions as
    int32 (123,718,280 edges; pairs may repeat), and OGB's split sizes over
    a permutation."""
    n, f, c = PRODUCTS_NODES, PRODUCTS_FEATS, PRODUCTS_CLASSES
    pairs = PRODUCTS_PAIRS
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    size = torch.full((c,), n // c, device=dev)
    size[: n % c] += 1
    src = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    cls = src % c
    member = (torch.rand(pairs, generator=gen, device=dev, dtype=torch.float64)
              * size[cls]).long()
    dst = torch.where(torch.rand(pairs, generator=gen, device=dev) < 0.8,
                      member * c + cls,
                      torch.randint(0, n, (pairs,), generator=gen, device=dev))
    dst = torch.where(dst == src, (src + 1) % n, dst)
    labels = torch.arange(n, device=dev) % c
    feat = (0.5 * torch.randn((c, f), generator=gen, device=dev)[labels]
            + torch.randn((n, f), generator=gen, device=dev))
    perm = torch.randperm(n, generator=gen, device=dev).cpu().numpy()
    a, b = PRODUCTS_SPLIT[0], PRODUCTS_SPLIT[0] + PRODUCTS_SPLIT[1]
    arrays = dict(src=torch.cat([src, dst]).int().cpu().numpy(),
                  dst=torch.cat([dst, src]).int().cpu().numpy(),
                  n_nodes=np.int64(n), feat=feat.cpu().numpy(),
                  labels=labels.cpu().numpy(), idx_train=perm[:a],
                  idx_val=perm[a:b], idx_test=perm[b:])
    del src, dst, cls, member, feat, labels
    np.savez(os.path.join(path, "ogbn-products.graph.npz"), **arrays)
    return arrays


def check_products(loaded, written) -> None:
    g, labels, *idx = loaded
    if (g.n_nodes != PRODUCTS_NODES or g.num_edges() != 2 * PRODUCTS_PAIRS
            or not np.array_equal(g.src, written["src"])
            or not np.array_equal(g.dst, written["dst"])
            or not np.array_equal(g.ndata["feat"], written["feat"])
            or not np.array_equal(labels, written["labels"])
            or not all(np.array_equal(a, written[k]) for a, k in zip(
                idx, ("idx_train", "idx_val", "idx_test")))):
        raise AssertionError("ogbn-products: the loader's output differs "
                             "from the arrays written")


def _write_splits(path: str, name: str, labelled, rs) -> list:
    """LINKX-style fixed splits: 5 permutations of the labelled nodes, 50 /
    25 / 25 into train, valid and test."""
    splits = []
    for _ in range(5):
        p = rs.permutation(labelled)
        a, b = len(p) // 2, 3 * len(p) // 4
        splits.append({"train": p[:a], "valid": p[a:b], "test": p[b:]})
    os.makedirs(os.path.join(path, "splits"), exist_ok=True)
    np.save(os.path.join(path, "splits", f"{name}-splits.npy"),
            np.array(splits, dtype=object), allow_pickle=True)
    return splits


def write_penn94(path: str, rs) -> dict:
    """penn94 (facebook100) in .mat with a splits file at its published
    shape: 41,554 nodes, PENN94_PAIRS random undirected pairs stored
    symmetric (about 1.36M edges), and a local_info of 7 columns with
    PENN94_RANGES values each: gender (col 1) 0/1/2, 0 (unlabelled) for 8%;
    col 5 has two values (one 0/1 column); the others give one-hot
    columns, about 4,800 in all. The splits hold labelled nodes only."""
    import scipy.io
    import scipy.sparse as sp

    n, pairs = PENN94_NODES, PENN94_PAIRS
    info = np.stack([rs.randint(0, r, n) for r in PENN94_RANGES], axis=1)
    info[:, 1] = rs.choice(3, n, p=[0.08, 0.46, 0.46])
    s, d = rs.randint(0, n, pairs), rs.randint(0, n, pairs)
    adj = sp.csr_matrix((np.ones(pairs), (s, d)), shape=(n, n))
    adj = adj + adj.T
    adj.data[:] = 1.0
    scipy.io.savemat(os.path.join(path, "penn94.mat"),
                     {"A": adj, "local_info": info})
    splits = _write_splits(path, "penn94", np.where(info[:, 1] > 0)[0], rs)
    return {"adj": adj, "info": info, "splits": splits}


def check_penn94(loaded, written) -> None:
    """Edges: the symmetric pattern with one self-loop a node; features:
    one 0/1 column for the two-valued column and k one-hot columns for a
    k-valued one; labels gender - 1, and -1 on no node of the split."""
    g, labels, itr, iva, ite = loaded
    adj, info = written["adj"], written["info"]
    cols = [info[:, 0]] + [info[:, j] for j in range(2, info.shape[1])]
    widths = [1 if len(np.unique(col)) == 2 else len(np.unique(col))
              for col in cols]
    feat = g.ndata["feat"]
    two = [col for col in cols if len(np.unique(col)) == 2]
    row_sums = np.full(len(labels), len(cols) - len(two), np.float32) + sum(
        (col == col.max()).astype(np.float32) for col in two)
    split = written["splits"][0]
    if (g.n_nodes != PENN94_NODES
            or g.num_edges() != adj.nnz - int((adj.diagonal() != 0).sum())
            + PENN94_NODES
            or feat.shape != (PENN94_NODES, sum(widths))
            or not np.array_equal(feat.sum(1), row_sums)
            or not np.array_equal(labels, info[:, 1] - 1)
            or not all(np.array_equal(a, split[k]) for a, k in zip(
                (itr, iva, ite), ("train", "valid", "test")))
            or (labels[np.concatenate([itr, iva, ite])] < 0).any()):
        raise AssertionError("penn94: the loader's output differs from the "
                             "file")
    log(f"penn94: {feat.shape[1]:,} feature columns ({widths}), "
        f"{int((labels < 0).sum()):,} unlabelled nodes (-1), none in a split")


def write_pokec(path: str, rs) -> dict:
    """pokec in .mat with a splits file, at a small size (POKEC_NODES
    nodes, 65 features as the published file has); label -1 for 10% of the
    nodes, the splits holding labelled nodes only."""
    import scipy.io

    n = POKEC_NODES
    arrays = {"edge_index": rs.randint(0, n, (2, POKEC_EDGES)),
              "node_feat": rs.randn(n, 65).astype(np.float32),
              "label": np.where(rs.rand(n) < 0.1, -1,
                                rs.randint(0, 2, n))[None]}
    scipy.io.savemat(os.path.join(path, "pokec.mat"), arrays)
    arrays["splits"] = _write_splits(path, "pokec",
                                     np.where(arrays["label"][0] >= 0)[0], rs)
    return arrays


def check_pokec(loaded, written) -> None:
    g, labels, itr, iva, ite = loaded
    split = written["splits"][0]
    if (not np.array_equal(g.ndata["feat"], written["node_feat"])
            or not np.array_equal(labels, written["label"][0])
            or int((g.src == g.dst).sum()) != POKEC_NODES
            or not all(np.array_equal(a, split[k]) for a, k in zip(
                (itr, iva, ite), ("train", "valid", "test")))):
        raise AssertionError("pokec: the loader's output differs from the "
                             "file")


def write_house(path: str, rs) -> dict:
    """house_class in the BGNN CSV form, small (HOUSE_NODES rows): an int
    column, a float column with empty fields, a categorical string column
    with empty fields, an int categorical column and a constant column;
    5 classes; one split; random edges."""
    n = HOUSE_NODES
    d = os.path.join(path, "house_class")
    os.makedirs(d)
    cols = {"year": rs.randint(1900, 2020, n).astype(str),
            "area": np.array([repr(float(v)) for v in rs.rand(n) * 300]),
            "district": rs.choice(["north", "south", "east", "west"], n),
            "rooms": rs.randint(1, 8, n).astype(str),
            "flag": np.full(n, "1")}
    cols["area"][rs.rand(n) < 0.1] = ""
    cols["district"][rs.rand(n) < 0.1] = ""
    with open(os.path.join(d, "X.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(n):
            f.write(",".join(col[i] for col in cols.values()) + "\n")
    y = rs.randint(0, 5, n)
    with open(os.path.join(d, "y.csv"), "w") as f:
        f.write("class\n" + "".join(f"{v}\n" for v in y))
    perm = rs.permutation(n)
    masks = {"0": {"train": perm[: n // 2].tolist(),
                   "val": perm[n // 2: 3 * n // 4].tolist(),
                   "test": perm[3 * n // 4:].tolist()}}
    with open(os.path.join(d, "masks.json"), "w") as f:
        json.dump(masks, f)
    with open(os.path.join(d, "cat_features.txt"), "w") as f:
        f.write("district\nrooms\n")
    np.savez(os.path.join(d, "graph.npz"), src=rs.randint(0, n, HOUSE_EDGES),
             dst=rs.randint(0, n, HOUSE_EDGES))
    return {"y": y, "masks": masks["0"]}


def check_house(loaded, written) -> None:
    g, labels, itr, iva, ite = loaded
    feat = g.ndata["feat"]
    if (feat.shape != (HOUSE_NODES, 5) or not np.isfinite(feat).all()
            or not np.array_equal(labels, written["y"])
            or not all(np.array_equal(a, written["masks"][k]) for a, k in zip(
                (itr, iva, ite), ("train", "val", "test")))):
        raise AssertionError("house_class: the loader's output differs from "
                             "the files")


def _load(name: str, data: str):
    from glnn_tpu_torch.graph.datasets import load_data

    return load_data(name, data, seed=0, labelrate_train=20,
                     labelrate_val=30, split_idx=0)


@contextlib.contextmanager
def timed_sorts():
    """native.sort_edges wrapped to record each call's (rows, host seconds,
    permutation) in the list it yields."""
    from glnn_tpu_torch import native

    calls, sort = [], native.sort_edges

    def timed(key, n):
        t0 = time.perf_counter()
        order = sort(key, n)
        calls.append((n, time.perf_counter() - t0, order))
        return order

    native.sort_edges = timed
    try:
        yield calls
    finally:
        native.sort_edges = sort


def _to_device(host, dev) -> tuple:
    """HostGraph.to_device split in its two stages, build_graph's two sorts
    apart: (graph, build_graph seconds, .to(device) seconds, [(rows,
    seconds, permutation) of the sort by dst, then by src])."""
    from glnn_tpu_torch import native
    from glnn_tpu_torch.graph.container import build_graph

    native.reset_counts()
    with timed_sorts() as sorts:
        t0 = time.perf_counter()
        cpu = build_graph(host.src, host.dst, host.n_nodes)
        t1 = time.perf_counter()
    if native.counts["sort_edges"] != 2 or len(sorts) != 2:
        raise AssertionError(f"build_graph sorted {len(sorts)} times, "
                             f"{native.counts['sort_edges']} natively")
    g = cpu.to(dev)
    torch.cuda.synchronize()
    return g, t1 - t0, time.perf_counter() - t1, sorts


def check_products_sort(host, order, native_s: float, card: str) -> dict:
    """build_graph's native sort by dst on products against one
    np.argsort(kind="stable") of the same keys, bit for bit, both timed."""
    t0 = time.perf_counter()
    want = np.argsort(host.dst, kind="stable")
    numpy_s = time.perf_counter() - t0
    if not np.array_equal(order, want):
        raise AssertionError("the native dst permutation of ogbn-products "
                             "differs from np.argsort(kind='stable')")
    log(f"check ogbn-products: build_graph's native sort by dst ({order.size:,}"
        f" edges) equal to np.argsort(kind='stable'); native {native_s:.2f} "
        f"s, np.argsort {numpy_s:.2f} s (host seconds); {card}")
    return dict(numpy_argsort_dst_s=numpy_s)


def phase_dataset_files(data: str, dev, host, labels, card: str) -> dict:
    """Write every family's file set, load each through load_data and hold
    it against what was written, and build each device graph: host seconds
    of each write, load_data, build_graph and .to(device), each beside the
    card. Returns the ingest record and the products arrays (host graph,
    labels, train ids) for the later timings."""
    log(f"datasets: {shutil.disk_usage(data).free / 1e9:.1f} GB free under "
        f"{data}")
    rs = np.random.RandomState(DATA_SEED)
    writers = {
        "cora": (lambda: write_cora(data, rs), check_cora),
        "ogbn-arxiv": (lambda: write_arxiv(data, rs, host, labels),
                       lambda got, w: check_arxiv(got, w, host)),
        "ogbn-products": (lambda: write_products(data, dev), check_products),
        "penn94": (lambda: write_penn94(data, rs), check_penn94),
        "pokec": (lambda: write_pokec(data, rs), check_pokec),
        "house_class": (lambda: write_house(data, rs), check_house),
    }
    ingest, products = {}, None
    for name, (write, check) in writers.items():
        t0 = time.perf_counter()
        written = write()
        t1 = time.perf_counter()
        loaded = _load(name, data)
        t2 = time.perf_counter()
        check(loaded, written)
        del written
        g, build_s, move_s, sorts = _to_device(loaded[0], dev)
        rec = dict(write_s=t1 - t0, load_data_s=t2 - t1, build_graph_s=build_s,
                   sort_dst_s=sorts[0][1], sort_src_s=sorts[1][1],
                   build_rest_s=build_s - sorts[0][1] - sorts[1][1],
                   to_device_s=move_s, nodes=g.n_nodes, edges=g.n_edges,
                   feats=int(loaded[0].ndata["feat"].shape[1]))
        ingest[name] = rec
        log(f"ingest {name}: N={g.n_nodes:,}, E={g.n_edges:,}, F="
            f"{rec['feats']}: write {rec['write_s']:.2f} s, load_data "
            f"{rec['load_data_s']:.2f} s, build_graph {build_s:.2f} s (native "
            f"sort by dst {rec['sort_dst_s']:.2f} s, by src "
            f"{rec['sort_src_s']:.2f} s, the rest {rec['build_rest_s']:.2f} "
            f"s), .to(device) {move_s:.2f} s (host seconds); {card}")
        if name == "ogbn-products":
            products = (loaded[0], loaded[1], loaded[2], g)
            rec.update(check_products_sort(loaded[0], sorts[0][2],
                                           sorts[0][1], card))
        del g, loaded, sorts
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("pandas", "sklearn", "ogb")]
    if bad:
        raise AssertionError(f"a loader imported {bad}")
    log("datasets: every family loaded and held against its files, with no "
        "pandas, sklearn or ogb module imported")
    return ingest, products


def products_adj(g):
    """A graph (the products graph, the hub graph) as an f32 CSR matrix for
    torch.sparse.mm, its repeated pairs coalesced into counts."""
    from glnn_tpu_torch.ops.cuda_build import row_ids

    n = g.n_nodes
    keys, _ = torch.sort(row_ids(g.indptr, n) * n + g.senders.long())
    keys, mult = torch.unique_consecutive(keys, return_counts=True)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=g.device)
    crow[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, keys % n, mult.float(), (n, n))


def check_products_spmm(spmm_cuda, g, adj) -> dict:
    """The exact tier at F = 100 on the products graph against
    torch.sparse.mm of the bf16-rounded rows in f32 (`products_adj`) at
    rtol 1e-5 / atol 1e-4, and the times of both beside the kernel's bytes
    bound. A plain gather would build a 49 GB [E, F] message here, so the
    library call holds the kernel."""
    n, e, f = g.n_nodes, g.n_edges, PRODUCTS_FEATS
    gen = torch.Generator(device=g.device).manual_seed(15)
    xb = spmm_cuda.to_message(torch.randn((n, f), generator=gen,
                                          device=g.device))
    lib_x = xb.float()
    plan = spmm_cuda.plan_of(g, "indptr", n)
    got = spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n, plan)
    want = torch.sparse.mm(adj, lib_x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    err = (got - want).abs().max().item()
    del got, want
    kernel_ms = time_ms(lambda: spmm_cuda.csr_sum_bf16(g.indptr, g.senders,
                                                       xb, n, plan), iters=10)
    lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_x), iters=10)
    nbytes = n * f * 2 + 4 * (e + n + 1) + n * f * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"check ogbn-products F={f}: exact kernel vs torch.sparse.mm max|err| "
        f"{err:.3e} ({adj.values().numel():,} distinct pairs of {e:,} "
        f"edges); time kernel {kernel_ms:.4f} ms, torch.sparse.mm "
        f"{lib_ms:.4f} ms, bytes bound {bound:.4f} ms")
    return dict(max_abs_err=err, ms=kernel_ms, library_ms=lib_ms,
                bound_ms=bound, edges=e)


def check_products_f32(spmm_cuda, g, adj) -> dict:
    """One f32 hop (spmm_csr_f32, feature_prop's kernel) at F = 100 on the
    products graph against torch.sparse.mm of the same f32 rows
    (`products_adj`) at rtol 1e-5 / atol 1e-4, a second launch bit-equal;
    the kernel's eager and device times, the library call's, and both
    bounds: each byte read once, and every E x F x 4 gathered byte from
    device memory."""
    n, e, f = g.n_nodes, g.n_edges, PRODUCTS_FEATS
    gen = torch.Generator(device=g.device).manual_seed(16)
    x = torch.randn((n, f), generator=gen, device=g.device)
    plan = spmm_cuda.graph_f32_plan(g)

    def kernel():
        return spmm_cuda.csr_sum_f32(g.indptr, g.senders, x, n, plan)

    got = kernel()
    want = torch.sparse.mm(adj, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if not torch.equal(got, kernel()):
        raise AssertionError("spmm_csr_f32 on ogbn-products: two launches "
                             "differ")
    err = (got - want).abs().max().item()
    del got, want
    torch.cuda.empty_cache()
    kernel_ms, device_ms = kernel_times(kernel, iters=5, replays=3)
    lib_ms = time_ms(lambda: torch.sparse.mm(adj, x), iters=5)
    bound = (2 * n * f * 4 + 4 * (e + n + 1)) / HBM_BYTES_PER_S * 1e3
    miss = e * f * 4 / HBM_BYTES_PER_S * 1e3
    log(f"check ogbn-products F={f}: spmm_csr_f32 vs torch.sparse.mm max|err| "
        f"{err:.3e}, two launches bit-equal, {plan.rows.numel()} rows split; "
        f"time kernel {kernel_ms:.4f} ms (device {device_ms:.4f}), "
        f"torch.sparse.mm f32 {lib_ms:.4f} ms, read-once bound {bound:.4f} "
        f"ms, all-miss gather bound {miss:.4f} ms")
    return dict(max_abs_err=err, ms=kernel_ms, device_ms=device_ms,
                library_ms=lib_ms, bound_ms=bound, all_miss_bound_ms=miss,
                edges=e)


def time_products(products, card: str) -> dict:
    """One sampled SAGE epoch at the ogbn-products row (3 x 256, batch
    norm, dropout 0.5, fan_out 5,10,15, batch 4096: 49 batches, the last
    of 7 seeds) and one all-node exact eval of the same model, host clock
    around each (ending in a synchronize), and the peak device memory."""
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import make_adam, make_eval_fn
    from glnn_tpu_torch.train.sage_sampled import make_sage_sampled_epoch_fn

    host, labels, idx_train, g = products
    dev = g.device
    feats = torch.as_tensor(host.ndata["feat"], device=dev)
    labels = torch.as_tensor(labels, device=dev)
    idx_train = torch.as_tensor(idx_train, device=dev)
    model = Model(dict(model_name="SAGE", num_layers=3, hidden_dim=256,
                       feat_dim=PRODUCTS_FEATS, label_dim=PRODUCTS_CLASSES,
                       dropout_ratio=0.5, norm_type="batch"),
                  torch.Generator().manual_seed(0)).to(dev)
    epoch = make_sage_sampled_epoch_fn(
        model, make_adam(model.parameters(), 0.003, 0.0), PRODUCTS_BATCH,
        FANOUTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = epoch(g, feats, labels, idx_train,
                    torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = make_eval_fn(model, exact=True)(g, feats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"ogbn-products epoch loss {loss} or eval not "
                             f"finite")
    rec = dict(epoch_s=t1 - t0, exact_eval_s=t2 - t1, peak_bytes=peak,
               batches=-(-idx_train.numel() // PRODUCTS_BATCH))
    log(f"time ogbn-products: sampled SAGE epoch ({rec['batches']} batches "
        f"of {PRODUCTS_BATCH}) {rec['epoch_s']:.3f} s, all-node exact eval "
        f"{rec['exact_eval_s']:.3f} s, peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; {card}")
    return rec


def phase_datasets(cuda_build, spmm_cuda, gat_cuda, workdir: str, host,
                   labels, dev, card: str) -> tuple:
    """The datasets phase: files, loads and ingest times; the products
    SpMM check and timings; then four paths through the CLIs with the
    package's own train.conf.yaml: OGB arxiv SAGE, CPF cora GCN, NonHom
    penn94 GCN (3 teacher epochs each) and OGB products SAGE (1 epoch),
    each teacher then an MLP student, counts set to 0 before and read
    after each path."""
    data = os.path.join(workdir, "data")
    os.makedirs(data)
    ingest, products = phase_dataset_files(data, dev, host, labels, card)
    adj = products_adj(products[3])
    ingest["ogbn-products"]["spmm_f100"] = check_products_spmm(
        spmm_cuda, products[3], adj)
    ingest["ogbn-products"]["spmm_f32_f100"] = check_products_f32(
        spmm_cuda, products[3], adj)
    del adj
    ingest["ogbn-products"].update(time_products(products, card))
    del products
    torch.cuda.empty_cache()

    modules = (cuda_build, spmm_cuda, gat_cuda)
    out = os.path.join(workdir, "outputs")
    sage = len(WIDTHS)      # the SAGE rows' three aggregations
    gcn = 2                 # two GCN layers, each aggregating after W
    paths = {}
    for tag, name, teacher, epochs, shape, want in (
            ("OGB arxiv SAGE", "ogbn-arxiv", "SAGE", TEACHER_EPOCHS,
             (N_NODES, N_CLASSES),
             {"spmm_csr_int8": sage * TEACHER_EPOCHS, "spmm_csr_bf16": sage}),
            ("CPF cora GCN", "cora", "GCN", TEACHER_EPOCHS,
             (CORA_LCC, CORA_CLASSES),
             {"spmm_csr_bf16": gcn * (2 * TEACHER_EPOCHS + 1),
              "spmm_csr_int8": gcn * TEACHER_EPOCHS}),
            ("NonHom penn94 GCN", "penn94", "GCN", TEACHER_EPOCHS,
             (PENN94_NODES, 2),
             {"spmm_csr_bf16": gcn * (2 * TEACHER_EPOCHS + 1),
              "spmm_csr_int8": gcn * TEACHER_EPOCHS}),
            ("OGB products SAGE", "ogbn-products", "SAGE", 1,
             (PRODUCTS_NODES, PRODUCTS_CLASSES),
             {"spmm_csr_int8": sage, "spmm_csr_bf16": sage})):
        common = ["--device", "0", "--dataset", name, "--data_path", data,
                  "--eval_interval", "1", "--output_path", out]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        paths[tag] = drive_path(teacher, workdir, common, modules,
                                dataset=name, shape=shape, epochs=epochs)
        check_counts(tag, paths[tag], want)
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} path: {time.perf_counter() - t0:.2f} s, peak device "
            f"memory {peak / 2 ** 30:.2f} GiB; {card}")
        if name == "ogbn-products":
            ingest[name]["cli_peak_bytes"] = peak
        torch.cuda.empty_cache()
    return paths, ingest


# ---------------------------------------------------------------------------
# Phase 4d: the experiment harness on the card (glnn_synth through python -m
# glnn_tpu_torch.experiments.run_experiments, with no --device; the dry run
# of every experiment and of reproduce_all), then the profiler traces of a
# GAT training step, an exact all-node SAGE eval and a sampled SAGE epoch,
# each with its device-op report.
# ---------------------------------------------------------------------------

EXP_DATASET = "synth-n2048-c7-f128-d10-noise3.0"   # glnn_synth's graph
EXP_SHAPE = (2048, 7)
# the JAX package's record of the same experiment
# (experiments/glnn_synth_r4.txt); logged beside the port's rows, not gated
JAX_GLNN_SYNTH = {
    f"tran/{EXP_DATASET}/SAGE": "1.0000 0.0000",
    f"tran/{EXP_DATASET}/GLNN": "1.0000 0.0000",
    f"ind/{EXP_DATASET}/SAGE": "1.0000 1.0000 0.0000 0.0000",
    f"ind/{EXP_DATASET}/GLNN": "1.0000 0.6342 0.0000 0.0029",
}
# glnn_synth's children in order: label, numbers in its row, setting
# directory, run directory
EXP_CHILDREN = tuple(
    (f"{e}/{EXP_DATASET}/{model}", n, sub, run)
    for e, n, sub in (("tran", 2, "transductive"),
                      ("ind", 4, "inductive/split_rate_0.2"))
    for model, run in (("SAGE", "SAGE"), ("GLNN", "SAGE_MLP")))
TRACE_ITERS = 3              # traced calls of a GAT step or a SAGE eval
LIBRARIES = ("libgat.so", "libgraphops.so", "libspmm.so", "libspmm_f32.so")


def _built(native) -> dict:
    """Each library under build/glnn_tpu_torch: (mtime ns, inode). A
    rebuild replaces the file, which changes both."""
    got = {p.name: (p.stat().st_mtime_ns, p.stat().st_ino)
           for p in native.BUILD_DIR.glob("lib*.so")}
    if sorted(got) != list(LIBRARIES):
        raise AssertionError(f"built libraries {sorted(got)}, expected "
                             f"{LIBRARIES}")
    return got


def _log_span_s(first_log: str, last_log: str) -> float:
    """Seconds from the first line of one CLI log to the last line of
    another (the logs' timestamps have 1 s resolution)."""
    import datetime

    def stamp(path, index):
        with open(path) as f:
            line = f.read().splitlines()[index]
        return datetime.datetime.strptime(line.split(": ", 1)[0],
                                          "%b%d %H-%M-%S")

    return (stamp(last_log, -1) - stamp(first_log, 0)).total_seconds()


def _launches_line(log_path: str) -> dict:
    """The last `launches {...}` line of a CLI run's log."""
    with open(log_path) as f:
        lines = [ln for ln in f if ": launches {" in ln]
    if not lines:
        raise AssertionError(f"{log_path} has no launches line")
    return json.loads(lines[-1].split("launches ", 1)[1])


def check_dry_runs() -> dict:
    """The dry run of every experiment and of reproduce_all, in process,
    with subprocess.run replaced by a failure: each prints its commands,
    starts no child and writes nothing."""
    from unittest import mock

    from glnn_tpu_torch.experiments import reproduce_all, run_experiments

    plans = {}
    runs = [(exp, run_experiments.main, [exp, "--dry_run"])
            for exp in sorted(run_experiments.EXPERIMENTS)]
    runs.append(("reproduce_all", reproduce_all.main, ["--dry_run"]))
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        with mock.patch.object(subprocess, "run", side_effect=AssertionError(
                "a dry run started a child")):
            for name, main_fn, argv in runs:
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    main_fn(argv)
                plans[name] = sum(line.startswith("+ ")
                                  for line in printed.getvalue().splitlines())
        if os.listdir(wd):
            raise AssertionError(f"the dry runs wrote {os.listdir(wd)}")
    if not all(plans.values()):
        raise AssertionError(f"a dry run printed no command: {plans}")
    log(f"dry runs: commands printed {plans}; no child started, nothing "
        f"written")
    return plans


def phase_experiments(native, card: str, device: str = "cuda:0") -> tuple:
    """glnn_synth through the harness in a temporary work directory, with
    no --device (cuda:0; a CPU rehearsal passes device "cpu", which forwards
    --device -1): its four rows, every child's log (the device, the native
    tier, launches with no plain version on CUDA; on the card the SAGE
    teachers on both SpMM tiers), every seed's out.npz and each run's
    exp_results; then the aggregator over that tree, and the dry runs. No
    child may rebuild a library. Returns (per child: label, seconds, row,
    launches; the dry runs' command counts)."""
    from glnn_tpu_torch.experiments import run_experiments

    on_card = device != "cpu"
    extra = [] if on_card else ["--device", "-1"]
    built = _built(native)
    children = []
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m",
             "glnn_tpu_torch.experiments.run_experiments", "glnn_synth",
             *extra], cwd=wd, env=run_experiments.child_env(),
            capture_output=True, text=True, timeout=900)
        harness_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"glnn_synth exited {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
        printed = res.stdout.splitlines()
        cmds = [ln[2:] for ln in printed if ln.startswith("+ ")]
        seconds = [float(ln[2:].split()[0]) for ln in printed
                   if ln.startswith("= ")]
        with open(os.path.join(wd, "glnn_synth.txt")) as f:
            rows = [ln.rstrip("\n") for ln in f if ln.strip()]
        if not (len(cmds) == len(seconds) == len(rows) == len(EXP_CHILDREN)):
            raise AssertionError(f"glnn_synth ran {cmds}, wrote {rows}")
        for cmd, line, secs, (label, n, sub, name) in zip(
                cmds, rows, seconds, EXP_CHILDREN):
            got, row = (s.strip() for s in line.split("\t", 1))
            values = [float(v) for v in row.split()]
            if (got != label or len(values) != n
                    or ("--device" in cmd) != bool(extra)
                    or not all(0.0 <= v <= 1.0 for v in values)):
                raise AssertionError(f"glnn_synth row {line!r} of {cmd!r}")
            run = os.path.join(wd, "outputs", sub, EXP_DATASET, name)
            if not os.path.isfile(os.path.join(run, "exp_results")):
                raise AssertionError(f"{run} has no exp_results")
            for seed in (0, 1):
                path = os.path.join(run, f"seed_{seed}")
                check_out(os.path.join(path, "out.npz"),
                          f"glnn_synth {label} seed {seed}", EXP_SHAPE)
                with open(os.path.join(path, "log")) as f:
                    if f"device: {device}" not in f.read():
                        raise AssertionError(f"{path}/log names no {device}")
                check_native_tier(f"glnn_synth {label}",
                                  os.path.join(path, "log"))
            # the process's launches, both seeds, from its last seed's log
            launched = _launches_line(os.path.join(run, "seed_1", "log"))
            tiers = launched["spmm_csr_int8"] and launched["spmm_csr_bf16"]
            if launched["plain_on_cuda"] or (on_card and name == "SAGE"
                                             and not tiers):
                raise AssertionError(f"glnn_synth {label} launched "
                                     f"{launched}")
            # from the first seed's first log line to the last seed's
            # launches line: the child's work after its imports and set-up
            logged = _log_span_s(os.path.join(run, "seed_0", "log"),
                                 os.path.join(run, "seed_1", "log"))
            children.append({"label": label, "s": secs, "logged_s": logged,
                             "row": row, "launches": launched})
            log(f"glnn_synth {label}: {secs:.2f} s ({logged:.0f} s between "
                f"its first and last log line), row {row} (JAX's record "
                f"{JAX_GLNN_SYNTH[label]}); launches "
                f"{ {k: v for k, v in launched.items() if v} }")
        agg = subprocess.run(
            [sys.executable, "-m",
             "glnn_tpu_torch.experiments.aggregate_table3"], cwd=wd,
            env=run_experiments.child_env(), capture_output=True, text=True,
            timeout=300)
        if agg.returncode != 0 or not os.path.isfile(
                os.path.join(wd, "table3.txt")):
            raise AssertionError(f"the aggregator exited {agg.returncode}:\n"
                                 f"{agg.stderr[-3000:]}")
    if _built(native) != built:
        raise AssertionError("a glnn_synth child rebuilt a library under "
                             "build/glnn_tpu_torch")
    log(f"glnn_synth: harness {harness_s:.2f} s for {len(children)} children "
        f"on {device}, no library rebuilt; the aggregator over its tree "
        f"exited 0 ({len(agg.stdout.splitlines())} table lines); {card}")
    return children, check_dry_runs()


def _counts(modules) -> dict:
    return {k: v for module in modules for k, v in module.counts.items()}


def traced_path(tag: str, fn, iters: int, want, modules, out_dir: str,
                dev, card: str) -> tuple:
    """trace_and_report of `fn` on `dev` (one warm call, then `iters`
    traced ones), the counts set to 0 just before: every port kernel in the
    report counted as often as its counter moved over the traced calls, on
    the card the kernels `want` among them, no plain version on CUDA; then
    one more call without the trace, the yardstick of what tracing costs.
    Logs one `trace {...}` line; returns (that line, the counts over all
    the calls)."""
    from glnn_tpu_torch.utils.trace_report import trace_and_report

    marks, calls_ms = [], []

    def call():
        marks.append(_counts(modules))
        t0 = time.perf_counter()
        fn()
        calls_ms.append((time.perf_counter() - t0) * 1e3)

    for module in modules:
        module.reset_counts()
    t0 = time.perf_counter()
    res = trace_and_report(call, dev, iters=iters, out_dir=out_dir,
                           quiet=True)
    trace_s = time.perf_counter() - t0
    after = _counts(modules)
    call()
    total = _counts(modules)
    rows = {r.name: r for r in res["rows"]}
    traced = {k: after[k] - marks[1][k] for k in after}
    for name in SOURCES:
        seen = rows[name].count if name in rows else 0
        if seen != traced[name] or (dev.type == "cuda" and name in want
                                    and not seen):
            raise AssertionError(f"{tag} trace: {name} {seen} times, its "
                                 f"counter {traced[name]}")
    if total["plain_on_cuda"] or res["device"] != dev.type:
        raise AssertionError(f"{tag}: {total['plain_on_cuda']} plain calls "
                             f"on CUDA; a {res['device']} trace")
    device_ms = sum(r.total_ms for r in res["rows"])
    line = {
        "path": tag, "card": card, "iters": iters,
        "busy_ms": res["busy_ms"], "window_ms": res["window_ms"],
        "idle_share": res["idle_share"],
        "device_ms_per_iter": res["total_ms_per_iter"],
        "untraced_calls_ms": [calls_ms[0], calls_ms[-1]],
        "traced_calls_ms": calls_ms[1:-1], "trace_s": trace_s,
        "kernel_share": {n: rows[n].total_ms / device_ms for n in SOURCES
                         if n in rows},
        "launches": {n: traced[n] for n in SOURCES if traced[n]},
        "top": [[r.name[:100], r.count, r.ms_per_iter]
                for r in res["rows"][:10]]}
    log(f"trace {json.dumps(line)}")
    return line, total


def phase_traces(cuda_build, spmm_cuda, gat_cuda, host, labels, idx_train,
                 g, card: str) -> tuple:
    """One full-batch GAT training step (the published synth GAT row,
    dropout from a device generator: seed mode), one exact all-node SAGE
    eval and one sampled SAGE epoch (Floyd, f32; the ogbn-arxiv SAGE row) on
    the smoke graph, each under traced_path. Returns (the trace lines, the
    counts of each path)."""
    from glnn_tpu_torch.cli import train_teacher
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import (make_adam, make_eval_fn,
                                      make_gnn_train_step)
    from glnn_tpu_torch.train.sage_sampled import make_sage_sampled_epoch_fn
    from glnn_tpu_torch.utils import get_training_config
    from glnn_tpu_torch.utils.config import merge_args_with_config

    dev = g.device
    feats = torch.as_tensor(host.ndata["feat"], device=dev)
    y = torch.as_tensor(labels, device=dev)
    idx = torch.as_tensor(idx_train, device=dev)
    defaults = vars(train_teacher.get_args([]))
    modules = (cuda_build, spmm_cuda, gat_cuda)
    lines, launched = {}, {}
    with tempfile.TemporaryDirectory() as wd:
        cfg = os.path.join(wd, "arxiv.conf.yaml")
        _config_yaml(cfg)

        def model_of(name):
            conf = merge_args_with_config(
                dict(defaults, feat_dim=feats.shape[1], label_dim=N_CLASSES),
                get_training_config(cfg, name, DATASET))
            model = Model(conf, torch.Generator().manual_seed(0)).to(dev)
            return model, make_adam(model.parameters(), conf["learning_rate"],
                                    conf["weight_decay"])

        gat, gat_adam = model_of("GAT")
        step = make_gnn_train_step(gat, gat_adam)
        sage, sage_adam = model_of("SAGE")
        evaluate = make_eval_fn(sage, exact=True)
        epoch = make_sage_sampled_epoch_fn(sage, sage_adam, BATCH, FANOUTS)
        gen = torch.Generator(device=dev).manual_seed(0)
        for tag, fn, iters, want in (
                ("GAT step", lambda: float(step(g, feats, y, idx, gen)),
                 TRACE_ITERS, ("gat_prep", "gat_fwd", "gat_bwd",
                               "spmm_csr_bf16")),
                ("SAGE eval", lambda: float(evaluate(g, feats)[0, 0]),
                 TRACE_ITERS, ("spmm_csr_bf16",)),
                # sampled training runs no kernel of the port
                ("SAGE epoch", lambda: epoch(g, feats, y, idx, gen)[0], 1,
                 ())):
            lines[tag], launched[f"trace {tag}"] = traced_path(
                tag, fn, iters, want, modules, os.path.join(wd, "traces"),
                dev, card)
    torch.cuda.empty_cache()
    return lines, launched


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
    # the graph's kept hub plans: no host synchronisation in a timed call
    plan = spmm_cuda.plan_of(g, "indptr", n)
    t_plan = spmm_cuda.plan_of(g, "t_indptr", n)
    rows = {name: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                       gather_bytes=0, library_ms=0.0, per_width={})
            for name in unweighted}
    for i, f in enumerate(WIDTHS + GCN_WIDTHS):
        in_sum = i < len(WIDTHS)
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        q, s = spmm_cuda.quantize_cols(x)
        idx_bytes = 4 * (e + n + 1)
        cases = {
            "spmm_csr_bf16": (
                lambda: spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n,
                                               plan),
                lambda: spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n),
                n * f * 2 + idx_bytes + n * f * 4, e * f * 2),
            "spmm_csr_int8": (
                lambda: spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n,
                                               plan),
                lambda: spmm_cuda.plain_csr_sum_int8(g.indptr, g.senders, q, s,
                                                     n),
                n * f + 4 * f + idx_bytes + n * f * 4, e * f),
        }
        # the library call gets the exact tier's bf16 values, held in f32
        lib_in = xb.float()
        torch.testing.assert_close(
            torch.sparse.mm(adj, lib_in),
            spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n, plan),
            rtol=1e-5, atol=1e-4)
        lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_in))
        for name, (kernel, plain, nbytes, gbytes) in cases.items():
            (k_ms, k_dev), p_ms = kernel_times(kernel), time_ms(plain)
            row = rows[name]
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            row["per_width"][f] = dict(ms=k_ms, device_ms=k_dev,
                                       plain_ms=p_ms, library_ms=lib_ms,
                                       bound_ms=bound)
            log(f"time F={f} {name}: kernel {k_ms:.4f} ms (device "
                f"{k_dev:.4f}), plain "
                f"{p_ms:.4f} ms, torch.sparse.mm f32 {lib_ms:.4f} ms, bytes "
                f"bound {bound:.4f} ms" + ("" if in_sum else " (GCN width)"))
            if not in_sum:
                continue
            row["ms"] += k_ms
            row["device_ms"] += k_dev
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
                                                dh, n, t_plan)
        lib_in = dh.float()
        torch.testing.assert_close(torch.sparse.mm(t_adj, lib_in), kernel(),
                                   rtol=1e-5, atol=1e-4)
        k_ms, k_dev = kernel_times(kernel)
        p_ms = time_ms(lambda: spmm_cuda.plain_csr_sum_bf16(
            g.t_indptr, g.t_receivers, dh, n))
        lib_ms = time_ms(lambda: torch.sparse.mm(t_adj, lib_in))
        bound = (n * f * 2 + 4 * (e + n + 1) + n * f * 4) / HBM_BYTES_PER_S * 1e3
        rows["spmm_csr_bf16"]["per_width"][f"{f} transposed"] = dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=bound)
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
            {"device_ms": row["device_ms"], "per_width_ms": row["per_width"]}))
        # every gathered row counted once per in-edge, over the HBM rate:
        # no bound, since x is partly served from L2
        log(f"{name}: E x F x itemsize of gathered rows over "
            f"{HBM_BYTES_PER_S:.3g} B/s would take "
            f"{row['gather_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return out


def phase_times_gat(gat_cuda, g, launches: dict, errs: dict) -> list:
    """One GAT training step's two layers per kernel, dropout in seed mode
    as the path runs it: kernel, plain version (for gat_prep the torch
    prep, the path before this kernel), bound. Bytes count each input read
    once and each output written once (no mask in seed mode, an 8-byte
    seed); the mask mode's time and bound (the uint8 [E, H] mask read
    once more) are in the rows' detail. Operations count an exponential as
    one (forward about 2D + 6 per edge and head, backward 9D + 18, prep 4
    per feature)."""
    n, e = g.n_nodes, g.n_edges
    idx_bytes = 4 * (e + n + 1)
    rows = {name: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                       per_layer={})
            for name in ("gat_prep", "gat_fwd", "gat_bwd")}
    from glnn_tpu_torch.ops import spmm_cuda

    # the GAT layer's kept plan of the graph
    plan = spmm_cuda.plan_of(g, "indptr", n, gat_cuda.GAT_CHUNK)
    for h, d in GAT_SHAPES:
        hd = h * d
        args, dout, al_b = gat_inputs(gat_cuda, g, h, d, ATTN_DROP, 7)
        margs = gat_inputs(gat_cuda, g, h, d, ATTN_DROP, 7, "mask")[0]
        _, smax, denom = gat_cuda.gat_fwd(*args, plan=plan)
        gen = torch.Generator(device=g.device).manual_seed(12)
        feat = torch.randn((n, h, d), generator=gen, device=g.device)
        al, ar = (0.3 * torch.randn((h, d), generator=gen, device=g.device)
                  for _ in range(2))
        # indices, bf16 features, f32 el, bf16 er, the seed
        fwd_in = idx_bytes + n * hd * 2 + n * h * 4 + n * h * 2 + 8
        cases = {
            # f32 features and attention vectors in; bf16 features, f32
            # el and bf16 er out
            "gat_prep": (lambda: gat_cuda.prep(feat, al, ar),
                         lambda: gat_cuda.plain_prep(feat, al, ar),
                         n * hd * 4 + 2 * hd * 4 + n * hd * 2 + n * h * 6,
                         4 * n * hd, None),
            "gat_fwd": (lambda: gat_cuda.gat_fwd(*args, plan=plan),
                        lambda: gat_cuda.plain_gat_fwd(*args),
                        fwd_in + n * hd * 4 + 2 * n * h * 4,
                        e * h * (2 * d + 6),
                        lambda: gat_cuda.gat_fwd(*margs, plan=plan)),
            # plus max, denom, f32 dout and bf16 attn_l in; der, the bf16
            # [E, H*D] message and dattn_l out
            "gat_bwd": (lambda: gat_cuda.gat_bwd(*args, smax, denom, dout,
                                                 al_b, plan=plan),
                        lambda: gat_cuda.plain_gat_bwd(*args, smax, denom,
                                                       dout, al_b),
                        fwd_in + 2 * n * h * 4 + n * hd * 4 + hd * 2
                        + n * h * 4 + e * hd * 2 + hd * 4,
                        e * h * (9 * d + 18),
                        lambda: gat_cuda.gat_bwd(*margs, smax, denom, dout,
                                                 al_b, plan=plan)),
        }
        for name, (kernel, plain, nbytes, ops, masked) in cases.items():
            (k_ms, k_dev), p_ms = kernel_times(kernel), time_ms(plain,
                                                                  iters=5)
            row = rows[name]
            row["ms"] += k_ms
            row["device_ms"] += k_dev
            row["plain_ms"] += p_ms
            row["bytes"] += nbytes
            row["ops"] += ops
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            detail = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                          bound_ms=bound)
            if masked is not None:
                detail["mask_mode_ms"] = time_ms(masked)
                detail["mask_mode_bound_ms"] = (
                    (nbytes - 8 + e * h) / HBM_BYTES_PER_S * 1e3)
            row["per_layer"][f"H={h},D={d}"] = detail
            log(f"time (H, D) = ({h}, {d}) {name}: kernel {k_ms:.4f} ms "
                f"(device {k_dev:.4f})"
                + (" (seed mode), mask mode {:.4f} ms (bound {:.4f})".format(
                    detail["mask_mode_ms"], detail["mask_mode_bound_ms"])
                   if masked is not None else "")
                + f", plain {p_ms:.4f} ms, bytes bound {bound:.4f} ms")
        del args, margs, feat
    return [_row(name, row["ms"], row["plain_ms"], row["bytes"], row["ops"],
                 # no single PyTorch call computes fused GAT attention, or
                 # the bf16 cast with both per-head dot products
                 None, launches, errs,
                 f"one GAT training step's two layers, (H, D) = (8, 16) and "
                 f"(1, 40), attention dropout {ATTN_DROP} (seed mode), over "
                 f"N={n}, E={e}",
                 {"device_ms": row["device_ms"],
                  "per_layer_ms": row["per_layer"]})
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
    per_width, tot = {}, dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                              library_ms=0.0, bytes=0, ops=0)
    csr = spmm_cuda.weighted_csr(g)           # with the graph's kept plans
    walks = {"forward": (g.indptr, g.senders, None, w, csr.plan),
             "transposed": (g.t_indptr, g.t_receivers, g.t_edges,
                            w[g.t_edges.long()], csr.t_plan)}
    for walk, (indptr, cols, widx, lib_w, plan) in walks.items():
        x = torch.randn((n, f), generator=gen, device=g.device)
        kernel = lambda: spmm_cuda.csr_wsum_bf16(indptr, cols, widx, x, w, n,  # noqa: E731,E501
                                                 plan)
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
        (k_ms, k_dev), p_ms = kernel_times(kernel), time_ms(plain, iters=5)
        lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_x))
        per_width[f"F={f} {walk}"] = dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        for key, val in (("ms", k_ms), ("device_ms", k_dev),
                         ("plain_ms", p_ms),
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
                                                 x2, wh, n, csr.plan)
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
        k_ms, k_dev = kernel_times(kernel)
        p_ms = time_ms(lambda: spmm_cuda.plain_csr_wsum_bf16(
            g.indptr, g.senders, None, x2, wh, n), iters=5)
        lib_ms = time_ms(lambda: torch.bmm(adj, lib_x), iters=5)
        per_width[f"H={h},D={x.shape[2]} forward"] = dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
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
                 {"device_ms": tot["device_ms"], "per_width_ms": per_width})]


def phase_times_f32(spmm_cuda, refops, g, launches: dict, errs: dict) -> list:
    """One feature_prop hop at F = AUG_F (the smoke features' width):
    kernel (eager and device), plain version (refops.csr_sum_f32), library
    call (torch.sparse.mm of the f32 CSR adjacency, the same function), and
    both bounds: bytes read once (the f32 x rows, the indices, the f32
    output; `bound_ms`), and every gathered row from device memory
    (E x F x 4 bytes; `all_miss_bound_ms`)."""
    gen = torch.Generator(device=g.device).manual_seed(14)
    n, e, f = g.n_nodes, g.n_edges, AUG_F
    x = torch.randn((n, f), generator=gen, device=g.device)
    adj = _library_csr(g.indptr, g.senders, torch.ones(e, device=g.device), n)
    plan = spmm_cuda.graph_f32_plan(g)

    def kernel():
        return spmm_cuda.csr_sum_f32(g.indptr, g.senders, x, n, plan)

    torch.testing.assert_close(torch.sparse.mm(adj, x), kernel(), rtol=1e-5,
                               atol=1e-4)
    k_ms, k_dev = kernel_times(kernel)
    p_ms = time_ms(lambda: refops.csr_sum_f32(g.indptr, g.senders, x, n),
                   iters=5)
    lib_ms = time_ms(lambda: torch.sparse.mm(adj, x))
    nbytes = n * f * 4 + 4 * (e + n + 1) + n * f * 4
    miss = e * f * 4 / HBM_BYTES_PER_S * 1e3
    log(f"time F={f} spmm_csr_f32: kernel {k_ms:.4f} ms (device {k_dev:.4f}), "
        f"plain {p_ms:.4f} ms, torch.sparse.mm f32 {lib_ms:.4f} ms, bytes "
        f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (read once), "
        f"{miss:.4f} ms (every gathered row from device memory)")
    return [_row("spmm_csr_f32", k_ms, p_ms, nbytes, e * f, lib_ms, launches,
                 errs, f"one feature_prop hop at F={f} over N={n}, E={e}",
                 {"device_ms": k_dev, "all_miss_bound_ms": miss})]


def softmax_library(gat_cuda, g, s, da, alpha, plan, rtol=1e-5) -> tuple:
    """(forward ms, backward ms) of torch.sparse.softmax over a COO
    [N, R N] (x H) tensor of g's edges with the scores s as values (hybrid
    for H > 1) and of its VJP, torch._sparse_softmax_backward_data, on the
    same layout: edge (v, u) at column u + N r, r its repeat of the pair
    (R - 1 the most repeats), so that no two edges merge and the softmax
    over dim 1 is the segment softmax; [N, N] on a graph without repeated
    pairs. The library's alpha held to alpha (the kernel's) at `rtol` and
    its backward to edge_softmax_bwd fed the library's alpha (rtol
    1e-4), with g's kept hub plan `plan`."""
    from glnn_tpu_torch.ops.cuda_build import row_ids

    n, (e, h) = g.n_nodes, s.shape
    dst, src = row_ids(g.indptr, n), g.senders.long()
    by_pair = torch.argsort(dst * n + src, stable=True)
    pair = (dst * n + src)[by_pair]
    pos = torch.arange(e, device=g.device)
    first = torch.ones(e, dtype=torch.bool, device=g.device)
    first[1:] = pair[1:] != pair[:-1]
    repeat = torch.empty_like(pos)
    repeat[by_pair] = pos - torch.cummax(torch.where(first, pos, 0), 0)[0]
    cols = src + n * repeat
    width = n * (int(repeat.max()) + 1)
    order = torch.argsort(dst * width + cols)
    coo_idx = torch.stack([dst[order], cols[order]])
    coo = torch.sparse_coo_tensor(
        coo_idx, s[order] if h > 1 else s[order, 0],
        (n, width) + ((h,) if h > 1 else ()), check_invariants=True).coalesce()
    lib = torch.sparse.softmax(coo, 1)
    torch.testing.assert_close(lib.values().reshape(e, h), alpha[order],
                               rtol=rtol, atol=1e-6)
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
        gat_cuda.edge_softmax_bwd(g.indptr, lib_alpha, da, n, plan)[order],
        rtol=1e-4, atol=1e-6)
    return lib_ms, time_ms(lib_bwd)


def phase_times_softmax(gat_cuda, g, launches: dict, errs: dict) -> list:
    """The segment softmax at the GAT shapes' heads ([E, 8] and [E, 1]):
    kernel (with the graph's kept hub plan), plain version, bound; beside
    them torch.sparse.softmax and its backward (`softmax_library`). Bytes:
    the [E, H] inputs and output and indptr."""
    from glnn_tpu_torch.ops import spmm_cuda

    gen = torch.Generator(device=g.device).manual_seed(8)
    n, e = g.n_nodes, g.n_edges
    plan = spmm_cuda.plan_of(g, "indptr", n)
    rows = {name: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bytes=0, ops=0, per_heads={})
            for name in ("edge_softmax_fwd", "edge_softmax_bwd")}
    for h, _ in GAT_SHAPES:
        s = 3.0 * torch.randn((e, h), generator=gen, device=g.device)
        da = torch.randn((e, h), generator=gen, device=g.device)
        alpha = gat_cuda.edge_softmax_fwd(g.indptr, s, n, plan)
        lib_ms, lib_bwd_ms = softmax_library(gat_cuda, g, s, da, alpha,
                                             plan)
        cases = {
            "edge_softmax_fwd": (
                lambda: gat_cuda.edge_softmax_fwd(g.indptr, s, n, plan),
                lambda: gat_cuda.plain_edge_softmax_fwd(g.indptr, s, n),
                2 * e * h * 4 + (n + 1) * 4, 5 * e * h, lib_ms),
            "edge_softmax_bwd": (
                lambda: gat_cuda.edge_softmax_bwd(g.indptr, alpha, da, n,
                                                  plan),
                lambda: gat_cuda.plain_edge_softmax_bwd(g.indptr, alpha, da,
                                                        n),
                3 * e * h * 4 + (n + 1) * 4, 4 * e * h, lib_bwd_ms),
        }
        for name, (kernel, plain, nbytes, ops, lib) in cases.items():
            (k_ms, k_dev), p_ms = kernel_times(kernel), time_ms(plain,
                                                                  iters=5)
            row = rows[name]
            row["ms"] += k_ms
            row["device_ms"] += k_dev
            row["plain_ms"] += p_ms
            row["bytes"] += nbytes
            row["ops"] += ops
            row["library_ms"] += lib
            row["per_heads"][f"H={h}"] = dict(
                ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log(f"time scores [E, {h}] {name}: kernel {k_ms:.4f} ms (device "
                f"{k_dev:.4f}), plain "
                f"{p_ms:.4f} ms, library {lib:.4f} ms, bytes bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return [_row(name, row["ms"], row["plain_ms"], row["bytes"], row["ops"],
                 row["library_ms"], launches, errs,
                 f"the op-surface GAT layer's two shapes' softmax, scores "
                 f"[E, 8] and [E, 1], over N={n}, E={e}",
                 {"device_ms": row["device_ms"],
                  "per_heads_ms": row["per_heads"]})
            for name, row in rows.items()]


def phase_times_tiers(host, labels, idx_train, g, card: str) -> dict:
    """The sampled SAGE epoch at the ogbn-arxiv recipe (3 x 256, batch norm,
    dropout 0.2, fan_out 5,10,15, 178 batches of 512) in floyd/f32,
    window/f32 and window/bf16 (the window tier with the aligned table),
    TIMED_EPOCHS epochs each after one warmup, round-robin across the
    three, each on its own model from seed 0; then the all-node MLP student inference (3 x 256, batch norm,
    N = 169,343) in f32 and in bf16 with the same weights, CUDA events over
    20 calls. Host wall clock for the epochs (they are host-bound), each
    line with the card's name and power limit."""
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import make_adam, make_mlp_eval_fn
    from glnn_tpu_torch.train.sage_sampled import make_sage_sampled_epoch_fn

    dev = g.device
    feats = torch.as_tensor(host.ndata["feat"], device=dev)
    labels = torch.as_tensor(labels, device=dev)
    idx_train = torch.as_tensor(idx_train, device=dev)
    base = dict(num_layers=3, hidden_dim=256, feat_dim=feats.shape[1],
                label_dim=N_CLASSES, dropout_ratio=0.2, norm_type="batch")
    out = {"card": card, "sage_epoch_s": {}, "mlp_inference_ms": {}}
    table = g.with_window_table()
    runs = {}
    for tier, dtype, graph in (("floyd", "float32", g),
                               ("window", "float32", table),
                               ("window", "bfloat16", table)):
        model = Model(dict(base, model_name="SAGE", compute_dtype=dtype),
                      torch.Generator().manual_seed(0)).to(dev)
        epoch = make_sage_sampled_epoch_fn(
            model, make_adam(model.parameters(), 0.01, 0.0), BATCH, FANOUTS,
            sampler_tier=tier)
        runs[f"{tier}/{dtype}"] = (epoch, graph,
                                   torch.Generator(device=dev).manual_seed(0))
    # one warmup epoch each, then the timed epochs round-robin, so that a
    # drift of the host's speed over the phase reaches every tier alike
    for rnd in range(1 + TIMED_EPOCHS):
        for key, (epoch, graph, gen) in runs.items():
            t0 = time.perf_counter()
            loss, _ = epoch(graph, feats, labels, idx_train, gen)
            dt = time.perf_counter() - t0
            if not math.isfinite(loss):
                raise AssertionError(f"sampled epoch {key}: loss {loss}")
            if rnd:
                out["sage_epoch_s"].setdefault(key, []).append(dt)
    for key, times in out["sage_epoch_s"].items():
        log(f"time sampled SAGE epoch {key}: {times} s; {card}")
    del runs
    outs = {}
    f32 = Model(dict(base, model_name="MLP"), torch.Generator().manual_seed(0))
    for dtype in ("float32", "bfloat16"):
        model = Model(dict(base, model_name="MLP", compute_dtype=dtype))
        model.load_state_dict(f32.state_dict())
        evaluate = make_mlp_eval_fn(model.to(dev))
        outs[dtype] = evaluate(feats)
        ms = time_ms(lambda: evaluate(feats))
        out["mlp_inference_ms"][dtype] = ms
        log(f"time MLP student all-node inference (3 x 256, batch norm, "
            f"N={feats.shape[0]}) {dtype}: {ms:.4f} ms; {card}")
    want, got = outs["float32"], outs["bfloat16"]
    agree = (want.argmax(1) == got.argmax(1)).float().mean().item()
    err = (got - want).abs().max().item()
    # the bound tests/test_torch_bf16_window.py holds bf16 logits to
    if got.dtype != torch.float32 or err > 3e-2 * want.abs().max().item():
        raise AssertionError(f"bf16 MLP inference: {got.dtype}, max|err| "
                             f"{err} against f32")
    log(f"bf16 MLP inference: f32 log-probs, max|err| {err:.3e} against f32 "
        f"(max|f32| {want.abs().max().item():.3e}), argmax equal on "
        f"{agree:.4%} of rows (random weights)")
    return out


def phase_check_hub_split(spmm_cuda, gat_cuda, hub) -> dict:
    """The kernels that split hub rows across warps with the hub graph's
    kept plans (spmm_cuda.plan_of): the template body's three policies at
    F = APPNP_F on the forward and the transposed walk, gat_fwd and
    gat_bwd at both GAT shapes in seed mode (on the GAT layer's plan, T =
    gat_cuda.GAT_CHUNK), and edge_softmax_fwd and edge_softmax_bwd on
    [E, 8] and [E, 1] scores. Each is held to its plain version at the
    tolerances of the checks above, a second launch must be bit-equal to
    the first (no atomics), every call must launch every pass (two for the
    template and edge_softmax_bwd, three for gat_fwd, gat_bwd and
    edge_softmax_fwd), and the three plans (the forward CSR at HUB_CHUNK
    and at GAT_CHUNK, the transposed one at HUB_CHUNK) must have been
    built once each however many calls walked them (the checks above kept
    theirs on the graph: they are dropped first). Returns the max |error|
    per kernel."""
    gen = torch.Generator(device=hub.device).manual_seed(21)
    n, e = hub.n_nodes, hub.n_edges
    hub.cache.clear()
    spmm_cuda.builds["hub_plan"] = 0
    plans = {"forward": spmm_cuda.plan_of(hub, "indptr", n),
             "transposed": spmm_cuda.plan_of(hub, "t_indptr", n),
             "gat": spmm_cuda.plan_of(hub, "indptr", n, gat_cuda.GAT_CHUNK)}
    x = torch.randn((n, APPNP_F), generator=gen, device=hub.device)
    xb = spmm_cuda.to_message(x)
    q, s = spmm_cuda.quantize_cols(x)
    w = (torch.rand(e, generator=gen, device=hub.device)
         >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
    errs = dict.fromkeys(("spmm_csr_bf16", "spmm_csr_int8",
                          "spmm_csr_weighted", "gat_fwd", "gat_bwd",
                          "edge_softmax_fwd", "edge_softmax_bwd"), 0.0)
    walks = {"forward": (hub.indptr, hub.senders, None),
             "transposed": (hub.t_indptr, hub.t_receivers, hub.t_edges)}
    for walk, (indptr, cols, widx) in walks.items():
        plan = plans[walk]
        cases = {
            "spmm_csr_bf16": (
                lambda: spmm_cuda.csr_sum_bf16(indptr, cols, xb, n, plan),
                lambda: spmm_cuda.plain_csr_sum_bf16(indptr, cols, xb, n)),
            "spmm_csr_int8": (
                lambda: spmm_cuda.csr_sum_int8(indptr, cols, q, s, n, plan),
                lambda: spmm_cuda.plain_csr_sum_int8(indptr, cols, q, s, n)),
            "spmm_csr_weighted": (
                lambda: spmm_cuda.csr_wsum_bf16(indptr, cols, widx, x, w, n,
                                                plan),
                lambda: spmm_cuda.plain_csr_wsum_bf16(indptr, cols, widx, x,
                                                      w, n))}
        for name, (kernel, plain) in cases.items():
            before = spmm_cuda.counts[name]
            got, again = kernel(), kernel()
            launches = spmm_cuda.counts[name] - before
            want = plain()
            torch.cuda.synchronize()
            if launches != 4:
                raise AssertionError(f"{name} {walk} walk on the hub graph: "
                                     f"{launches} launches for two calls, "
                                     f"expected 4 (the walk and the sum of "
                                     f"the split rows each)")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {walk} walk on the hub graph: "
                                     f"two launches differ")
            if name == "spmm_csr_int8":
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {walk} walk on the hub "
                                         f"graph differs from plain")
                err = 0.0
            else:
                err = _held(f"{name} {walk}", got, want, 1e-5, 1e-4)
            errs[name] = max(errs[name], err)
            log(f"check hub split F={APPNP_F}: {name} {walk} walk vs plain "
                f"max|err| {err:.3e}; {plan.rows.numel()} rows split into "
                f"{plan.n_chunks} chunks of T = {plan.chunk}; two launches "
                f"bit-equal, {launches} launches")
    for h, d in GAT_SHAPES:
        args, dout, al_b = gat_inputs(gat_cuda, hub, h, d, ATTN_DROP, 30 + h)
        before = gat_cuda.counts["gat_fwd"]
        got = gat_cuda.gat_fwd(*args, plan=plans["gat"])
        again = gat_cuda.gat_fwd(*args, plan=plans["gat"])
        launches = gat_cuda.counts["gat_fwd"] - before
        want = gat_cuda.plain_gat_fwd(*args)
        torch.cuda.synchronize()
        tag = (f"(H, D) = ({h}, {d}), dropout {ATTN_DROP} (seed), T = "
               f"{plans['gat'].chunk}")
        if launches != 6:
            raise AssertionError(f"gat_fwd {tag} on the hub graph: "
                                 f"{launches} launches for two calls, "
                                 f"expected 6")
        for name, a, b in zip(("out", "max", "denom"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"gat_fwd {tag} on the hub graph: two "
                                     f"launches differ in {name}")
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"gat_fwd {tag} on the hub graph: segment "
                                 f"max differs from plain")
        e_fwd = {"out": _held("out", got[0], want[0], 1e-4, 1e-4),
                 "denom": _held("denom", got[2], want[2], 1e-4, 1e-4)}
        errs["gat_fwd"] = max(errs["gat_fwd"], *e_fwd.values())
        log(f"check hub split {tag}: gat_fwd vs plain max|err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in e_fwd.items()) + ", max exact; two "
            f"launches bit-equal, {launches} launches")
        # gat_bwd on the forward's max and den
        _, smax, denom = got
        before = gat_cuda.counts["gat_bwd"]
        got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b,
                               plan=plans["gat"])
        again = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b,
                                 plan=plans["gat"])
        launches = gat_cuda.counts["gat_bwd"] - before
        want = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
        torch.cuda.synchronize()
        if launches != 6:
            raise AssertionError(f"gat_bwd {tag} on the hub graph: "
                                 f"{launches} launches for two calls, "
                                 f"expected 6")
        for name, a, b in zip(("der", "msg", "dattn_l"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"gat_bwd {tag} on the hub graph: two "
                                     f"launches differ in {name}")
        e_bwd = {"der": _held("der", got[0], want[0], 1e-4, 1e-4),
                 "msg": _held("msg", got[1], want[1], 2.0 ** -7, 1e-5),
                 "dattn_l": _held("dattn_l", got[2], want[2], 1e-4, 1e-4)}
        errs["gat_bwd"] = max(errs["gat_bwd"], *e_bwd.values())
        log(f"check hub split {tag}: gat_bwd vs plain max|err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in e_bwd.items()) + f"; two launches "
            f"bit-equal, {launches} launches")
        del got, again, want
    for h, _ in GAT_SHAPES:
        scores = 3.0 * torch.randn((e, h), generator=gen, device=hub.device)
        before = gat_cuda.counts["edge_softmax_fwd"]
        got = gat_cuda.edge_softmax_fwd(hub.indptr, scores, n,
                                        plans["forward"])
        again = gat_cuda.edge_softmax_fwd(hub.indptr, scores, n,
                                          plans["forward"])
        launches = gat_cuda.counts["edge_softmax_fwd"] - before
        want = gat_cuda.plain_edge_softmax_fwd(hub.indptr, scores, n)
        torch.cuda.synchronize()
        if launches != 6:
            raise AssertionError(f"edge_softmax_fwd [E, {h}] on the hub "
                                 f"graph: {launches} launches for two "
                                 f"calls, expected 6")
        if not torch.equal(got, again):
            raise AssertionError(f"edge_softmax_fwd [E, {h}] on the hub "
                                 f"graph: two launches differ")
        err = _held(f"softmax [E, {h}]", got, want, 1e-5, 1e-6)
        errs["edge_softmax_fwd"] = max(errs["edge_softmax_fwd"], err)
        log(f"check hub split scores [E, {h}]: edge_softmax_fwd vs plain "
            f"max|err| {err:.3e}; two launches bit-equal, {launches} "
            f"launches")
        # the backward on the kernel's alpha: the chunks' parts of t, ds
        dalpha = torch.randn((e, h), generator=gen, device=hub.device)
        before = gat_cuda.counts["edge_softmax_bwd"]
        got_ds = gat_cuda.edge_softmax_bwd(hub.indptr, got, dalpha, n,
                                           plans["forward"])
        again = gat_cuda.edge_softmax_bwd(hub.indptr, got, dalpha, n,
                                          plans["forward"])
        launches = gat_cuda.counts["edge_softmax_bwd"] - before
        want = gat_cuda.plain_edge_softmax_bwd(hub.indptr, got, dalpha, n)
        torch.cuda.synchronize()
        if launches != 4:
            raise AssertionError(f"edge_softmax_bwd [E, {h}] on the hub "
                                 f"graph: {launches} launches for two "
                                 f"calls, expected 4")
        if not torch.equal(got_ds, again):
            raise AssertionError(f"edge_softmax_bwd [E, {h}] on the hub "
                                 f"graph: two launches differ")
        err = _held(f"softmax grad [E, {h}]", got_ds, want, 1e-4, 1e-6)
        errs["edge_softmax_bwd"] = max(errs["edge_softmax_bwd"], err)
        log(f"check hub split scores [E, {h}]: edge_softmax_bwd vs plain "
            f"max|err| {err:.3e}; two launches bit-equal, {launches} "
            f"launches")
        del got, again, want, got_ds
    builds = spmm_cuda.builds["hub_plan"]
    if builds != len(plans):
        raise AssertionError(f"{builds} hub plans built for the hub graph's "
                             f"{len(plans)} CSRs and T")
    log(f"hub plans: {builds} built, one per CSR and T ("
        + ", ".join(f"{k} {p.n_chunks} chunks of {p.rows.numel()} rows at "
                    f"T = {p.chunk}" for k, p in plans.items())
        + "), over every call above")
    return errs


def phase_check_appnp_hops(spmm_cuda, ops, refops, hub) -> None:
    """APPNP's hop fused into the template body's walks, on the hub graph
    with its kept plans (rows past HUB_CHUNK in both walks) at F = APPNP_F:
    the forward weighted walk (`Appnp<0>`) and the transposed one that
    gives dX (`Appnp<1>`) through spmm_cuda.appnp_wsum, and the int8 eval
    walk (`Appnp<2>`) through spmm_cuda.appnp_sum_int8, each held with
    torch.equal to the composition it replaces (gcn_norm_both on the exact
    kernels, or the int8 tier inside inference_mode, then the teleport; dX
    by autograd through it) and to its plain version, the weighted walks at
    the weighted sum's tolerance (the plain sum adds in another order), the
    int8 walk bit for bit; two launches bit-equal, two launches a call (the
    walk and the sum of the split rows); then appnp_hop's dX and dh0 against the composition's,
    and ops.appnp_hop taking the fused path in training and in the eval
    (ops.hop_counts) with no plain version on CUDA. Last, the device time
    of both weighted walks (kernel_times) at the cell's edge drop, which
    zeroes half the weights and so half the gathers, and at dense weights,
    beside the bytes bound (input and output read and written once)."""
    from glnn_tpu_torch.ops import cuda_build

    alpha = 0.1
    gen = torch.Generator(device=hub.device).manual_seed(22)
    n, e = hub.n_nodes, hub.n_edges
    x, h0, dout = (torch.randn((n, APPNP_F), generator=gen, device=hub.device)
                   for _ in range(3))
    w = (torch.rand(e, generator=gen, device=hub.device)
         >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
    src_norm, dst_norm = refops.degree_norms(hub)
    xg = x.clone().requires_grad_(True)
    composed = (1.0 - alpha) * ops.gcn_norm_both(hub, xg, w) + alpha * h0
    dx_composed, = torch.autograd.grad(composed, xg, dout)
    with torch.no_grad(), ops.inference_mode():
        int8_composed = ((1.0 - alpha) * ops.gcn_norm_both(hub, x)
                         + alpha * h0)
    q, scale = spmm_cuda.quantize_cols(x * src_norm[:, None])
    cases = {
        "spmm_csr_weighted forward (Appnp<0>)": (
            "spmm_csr_weighted",
            lambda: spmm_cuda.appnp_wsum(hub, x, w, src_norm, dst_norm, h0,
                                         alpha, False),
            spmm_cuda.plain_appnp_wsum(hub, x, w, src_norm, dst_norm, h0,
                                       alpha, False), composed.detach()),
        "spmm_csr_weighted transposed (Appnp<1>)": (
            "spmm_csr_weighted",
            lambda: spmm_cuda.appnp_wsum(hub, dout, w, dst_norm, src_norm,
                                         None, alpha, True),
            spmm_cuda.plain_appnp_wsum(hub, dout, w, dst_norm, src_norm,
                                       None, alpha, True), dx_composed),
        "spmm_csr_int8 eval (Appnp<2>)": (
            "spmm_csr_int8",
            lambda: spmm_cuda.appnp_sum_int8(hub, q, scale, dst_norm, h0,
                                             alpha),
            spmm_cuda.plain_appnp_sum_int8(hub, q, scale, dst_norm, h0,
                                           alpha), int8_composed)}
    for tag, (name, kernel, plain, want) in cases.items():
        before = spmm_cuda.counts[name]
        got, again = kernel(), kernel()
        launches = spmm_cuda.counts[name] - before
        torch.cuda.synchronize()
        if launches != 4:
            raise AssertionError(f"APPNP hop {tag} on the hub graph: "
                                 f"{launches} launches for two calls, "
                                 f"expected 4")
        for what, other in (("a second launch", again),
                            ("the composition", want)):
            if not torch.equal(got, other):
                diff = float((got - other).abs().max())
                raise AssertionError(f"APPNP hop {tag} on the hub graph "
                                     f"differs from {what} (max|diff| "
                                     f"{diff:.3e})")
        if name == "spmm_csr_int8":
            if not torch.equal(got, plain):
                raise AssertionError(f"APPNP hop {tag} on the hub graph "
                                     f"differs from its plain version")
            err = 0.0
        else:
            err = _held(f"APPNP hop {tag}", got, plain, 1e-5, 1e-4)
        log(f"check APPNP hop F={APPNP_F} on the hub graph: {tag} equal to "
            f"the composition, vs plain max|err| {err:.3e}, two launches "
            f"bit-equal, {launches} launches")
    a, b = x.clone().requires_grad_(True), h0.clone().requires_grad_(True)
    da, db = torch.autograd.grad(spmm_cuda.appnp_hop(hub, a, b, w, alpha),
                                 (a, b), dout)
    b = h0.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    dxc, dbc = torch.autograd.grad(
        (1.0 - alpha) * ops.gcn_norm_both(hub, xg, w) + alpha * b, (xg, b),
        dout)
    if not (torch.equal(da, dxc) and torch.equal(db, dbc)):
        raise AssertionError("APPNP hop on the hub graph: appnp_hop's dX or "
                             "dh0 differs from the composition's")
    ops.reset_counts()
    cuda_build.reset_counts()
    ops.appnp_hop(hub, x.requires_grad_(True), h0, w, alpha).sum().backward()
    x.requires_grad_(False)
    with torch.no_grad(), ops.inference_mode():
        ops.appnp_hop(hub, x, h0, None, alpha)
    torch.cuda.synchronize()
    hops = dict(ops.hop_counts)
    if hops != {"fused_weighted": 1, "fused_int8": 1, "composed": 0}:
        raise AssertionError(f"ops.appnp_hop on the hub graph took {hops}")
    if cuda_build.counts["plain_on_cuda"]:
        raise AssertionError(f"ops.appnp_hop ran a plain version on CUDA "
                             f"{cuda_build.counts['plain_on_cuda']} times")
    log(f"check APPNP hop: appnp_hop's dX and dh0 equal the composition's; "
        f"ops.appnp_hop paths {hops}, no plain version on CUDA")
    dense = torch.full_like(w, 1.0 / (1.0 - EDGE_DROP))
    nf = n * APPNP_F * 4
    # bytes as gnnbench/models/APPNP.py counts them (h0 and norms left out)
    bound = {False: (n + 1) * 4 + 2 * e * 4 + 2 * nf,
             True: (n + 1) * 4 + 3 * e * 4 + 2 * nf}
    for transposed in (False, True):
        walk = "transposed (Appnp<1>)" if transposed else "forward (Appnp<0>)"
        ms = {}
        for tag, wt in (("edge drop", w), ("dense", dense)):
            args = ((dout, wt, dst_norm, src_norm, None) if transposed
                    else (x, wt, src_norm, dst_norm, h0))
            ms[tag] = kernel_times(lambda: spmm_cuda.appnp_wsum(
                hub, *args, alpha, transposed))[1]
        log(f"time APPNP hop F={APPNP_F} on the hub graph: spmm_csr_weighted "
            f"{walk} device {ms['edge drop']:.4f} ms at edge drop "
            f"{EDGE_DROP}, {ms['dense']:.4f} ms dense, bytes bound "
            f"{bound[transposed] / HBM_BYTES_PER_S * 1e3:.4f} ms")


def phase_times_hub(spmm_cuda, gat_cuda, hub, kernels: list) -> None:
    """Device time (CUDA-graph replays) and eager time on the hub graph of
    each kernel that splits hub rows across warps, with the graph's kept
    plans: the template body's three policies at F = APPNP_F (beside
    torch.sparse.mm on the hub graph for the exact tier's function), the
    f32 sum at AUG_F, gat_fwd and gat_bwd at both GAT shapes (seed mode,
    the GAT layer's plan), edge_softmax_fwd and edge_softmax_bwd at [E, 8]
    and [E, 1], each beside its synth-graph device time; gat_prep, which
    walks no edge; torch.sparse.softmax and its backward on the hub graph
    beside the softmax kernels. Added to the rows' detail as
    `hub_graph_ms`, outside their sums."""
    gen = torch.Generator(device=hub.device).manual_seed(10)
    n, e = hub.n_nodes, hub.n_edges
    f = APPNP_F
    x = torch.randn((n, f), generator=gen, device=hub.device)
    xb = spmm_cuda.to_message(x)
    q, s = spmm_cuda.quantize_cols(x)
    w = (torch.rand(e, generator=gen, device=hub.device)
         >= EDGE_DROP).float() / (1.0 - EDGE_DROP)
    idx_bytes = 4 * (e + n + 1)
    x_aug = torch.randn((n, AUG_F), generator=gen, device=hub.device)
    plan = spmm_cuda.plan_of(hub, "indptr", n)
    gat_plan = spmm_cuda.plan_of(hub, "indptr", n, gat_cuda.GAT_CHUNK)
    f32_plan = spmm_cuda.graph_f32_plan(hub)
    synth = {row["name"]: row for row in kernels}
    # (kernel, width, bytes, synth-graph device ms)
    cases = {
        "spmm_csr_bf16": (lambda: spmm_cuda.csr_sum_bf16(
            hub.indptr, hub.senders, xb, n, plan), f, n * f * 6 + idx_bytes,
            synth["spmm_csr_bf16"]["per_width_ms"][f]["device_ms"]),
        "spmm_csr_int8": (lambda: spmm_cuda.csr_sum_int8(
            hub.indptr, hub.senders, q, s, n, plan), f,
            n * f * 5 + 4 * f + idx_bytes,
            synth["spmm_csr_int8"]["per_width_ms"][f]["device_ms"]),
        "spmm_csr_weighted": (lambda: spmm_cuda.csr_wsum_bf16(
            hub.indptr, hub.senders, None, x, w, n, plan), f,
            n * f * 8 + e * 4 + idx_bytes,
            synth["spmm_csr_weighted"]["per_width_ms"][f"F={f} forward"][
                "device_ms"]),
        "spmm_csr_f32": (lambda: spmm_cuda.csr_sum_f32(
            hub.indptr, hub.senders, x_aug, n, f32_plan), AUG_F,
            n * AUG_F * 8 + idx_bytes, synth["spmm_csr_f32"]["device_ms"]),
    }
    detail = {}
    for name, (kernel, width, nbytes, synth_ms) in cases.items():
        ms, dev_ms = kernel_times(kernel)
        detail[name] = {f"F={width}": dict(
            ms=ms, device_ms=dev_ms, synth_device_ms=synth_ms,
            x_synth=dev_ms / synth_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)}
        log(f"time hub graph F={width} {name}: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), {dev_ms / synth_ms:.2f} x its synth-graph "
            f"device time {synth_ms:.4f}, bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    # the library call on the hub graph: the exact tier's function, f32
    # sums of the bf16-rounded rows (repeated pairs coalesced into counts)
    adj = products_adj(hub)
    lib_in = xb.float()
    torch.testing.assert_close(torch.sparse.mm(adj, lib_in), cases[
        "spmm_csr_bf16"][0](), rtol=1e-5, atol=1e-4)
    lib_ms = time_ms(lambda: torch.sparse.mm(adj, lib_in))
    detail["spmm_csr_bf16"][f"F={f}"]["library_ms"] = lib_ms
    log(f"time hub graph F={f} torch.sparse.mm f32 (the exact tier's "
        f"function): {lib_ms:.4f} ms")
    del adj, lib_in
    for name in ("gat_prep", "gat_fwd", "gat_bwd", "edge_softmax_fwd",
                 "edge_softmax_bwd"):
        detail[name] = {}

    def timed(name, key, fn, synth_ms, note):
        ms, dev_ms = kernel_times(fn)
        detail[name][key] = dict(ms=ms, device_ms=dev_ms,
                                 synth_device_ms=synth_ms,
                                 x_synth=dev_ms / synth_ms)
        log(f"time hub graph {key} {name}: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}{note}), {dev_ms / synth_ms:.2f} x its synth-graph "
            f"device time {synth_ms:.4f}")

    for h, d in GAT_SHAPES:
        args, dout, al_b = gat_inputs(gat_cuda, hub, h, d, ATTN_DROP, 11)
        _, smax, denom = gat_cuda.gat_fwd(*args, plan=gat_plan)
        key = f"H={h},D={d}"
        gen = torch.Generator(device=hub.device).manual_seed(12)
        feat = torch.randn((n, h, d), generator=gen, device=hub.device)
        al, ar = (0.3 * torch.randn((h, d), generator=gen, device=hub.device)
                  for _ in range(2))
        timed("gat_prep", key, lambda: gat_cuda.prep(feat, al, ar),
              synth["gat_prep"]["per_layer_ms"][key]["device_ms"],
              "; it walks no edge")
        timed("gat_fwd", key, lambda: gat_cuda.gat_fwd(
            *args, plan=gat_plan),
            synth["gat_fwd"]["per_layer_ms"][key]["device_ms"],
            f", seed mode, T = {gat_plan.chunk}")
        timed("gat_bwd", key, lambda: gat_cuda.gat_bwd(
            *args, smax, denom, dout, al_b, plan=gat_plan),
            synth["gat_bwd"]["per_layer_ms"][key]["device_ms"],
            f", seed mode, T = {gat_plan.chunk}")
    for h, _ in GAT_SHAPES:
        scores = 3.0 * torch.randn((e, h), generator=gen, device=hub.device)
        dalpha = torch.randn((e, h), generator=gen, device=hub.device)
        alpha = gat_cuda.edge_softmax_fwd(hub.indptr, scores, n, plan)
        key = f"H={h}"
        timed("edge_softmax_fwd", key, lambda: gat_cuda.edge_softmax_fwd(
            hub.indptr, scores, n, plan),
            synth["edge_softmax_fwd"]["per_heads_ms"][key]["device_ms"], "")
        timed("edge_softmax_bwd", key, lambda: gat_cuda.edge_softmax_bwd(
            hub.indptr, alpha, dalpha, n, plan),
            synth["edge_softmax_bwd"]["per_heads_ms"][key]["device_ms"], "")
        # the library beside them; rows of 20,000 edges: a plain f32 sum
        # of their exponentials is about 1e-5 of itself off, the kernel's
        # compensated one is not
        lib_fwd, lib_bwd = softmax_library(gat_cuda, hub, scores, dalpha,
                                           alpha, plan, rtol=1e-4)
        detail["edge_softmax_fwd"][key]["library_ms"] = lib_fwd
        detail["edge_softmax_bwd"][key]["library_ms"] = lib_bwd
        log(f"time hub graph {key} torch.sparse.softmax {lib_fwd:.4f} ms, "
            f"its backward {lib_bwd:.4f} ms")
    for row in kernels:
        if row["name"] in detail:
            row["hub_graph_ms"] = detail[row["name"]]


@contextlib.contextmanager
def data_workdir():
    """A temporary directory with MIN_FREE_DISK bytes free for the dataset
    files: under TMPDIR, else beside this script."""
    for parent in (None, os.path.dirname(os.path.abspath(__file__))):
        with tempfile.TemporaryDirectory(dir=parent) as workdir:
            if shutil.disk_usage(workdir).free >= MIN_FREE_DISK:
                yield workdir
                return
    raise AssertionError(f"no temporary directory has "
                         f"{MIN_FREE_DISK / 1e9:.0f} GB free for the dataset "
                         f"files")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from glnn_tpu_torch import native, ops
    from glnn_tpu_torch.graph.datasets import load_synth_data
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, refops, spmm_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build(cuda_build, native)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    host, labels, idx_train, *_ = load_synth_data(
        DATASET, 0, LABELRATE_TRAIN, LABELRATE_VAL)
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
    errs, hub_errs, width_errs = {}, {}, {"smoke": {}, "hub": {}}
    for tag, gr, into in (("smoke", g, errs), ("hub", hub, hub_errs)):
        log(f"checks on the {tag} graph")
        into.update(phase_check(spmm_cuda, gr, width_errs[tag]))
        into["spmm_csr_f32"] = phase_check_f32(spmm_cuda, refops, gr)
        into.update(phase_check_gat(gat_cuda, gr))
        phase_check_gat_layer(gat_cuda, gr)
        into["spmm_csr_weighted"] = phase_check_weighted(spmm_cuda, gr)
        into.update(phase_check_softmax(gat_cuda, gr))
        phase_check_sampler(gr, tag)
        for name, err in phase_check_bf16(spmm_cuda, gr).items():
            into[f"{name} bf16 x"] = err
        log(f"{tag} graph: max|err| per kernel {into}")
        torch.cuda.empty_cache()
    for name, err in phase_check_hub_split(spmm_cuda, gat_cuda, hub).items():
        hub_errs[name] = max(hub_errs[name], err)
    phase_check_appnp_hops(spmm_cuda, ops, refops, hub)
    for name, err in hub_errs.items():
        errs[name] = max(errs[name], err)
    # the bf16-input checks are held in bf16 ulps, apart from the f32 ones
    bf16_errs = {name: errs.pop(f"{name} bf16 x")
                 for name in ("spmm_csr_bf16", "spmm_csr_int8")}
    for name in bf16_errs:
        hub_errs.pop(f"{name} bf16 x")
    op_surface = phase_op_surface(ops, cuda_build, spmm_cuda, gat_cuda, g)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main_path(cuda_build, spmm_cuda, gat_cuda, workdir,
                                   host, g)
    # the sharded paths: N_SHARDS ranks on this one card, over gloo
    from glnn_tpu_torch.distributed import mesh as dmesh

    os.environ[dmesh.SHARE_DEVICE_ENV] = "1"
    dist = phase_dist_checks(spmm_cuda, host, dev, smi)
    errs["spmm_csr_bf16"] = max(errs["spmm_csr_bf16"], dist["rect_hub_f40"],
                                *(r["max_abs_err"] for r in dist["ranks"]))
    # the per-edge halo ops against the plain versions of the same kernels
    for name in ("gat_fwd", "edge_softmax_fwd", "edge_softmax_bwd",
                 "spmm_csr_weighted"):
        errs[name] = max(errs[name], dist["halo_errs"][name])
    launches["op_surface halo"] = dist["per_op_counts"]
    with tempfile.TemporaryDirectory() as workdir:
        cfg = os.path.join(workdir, "arxiv.conf.yaml")
        _config_yaml(cfg)
        dist["paths"] = phase_dist_paths(workdir, cfg, host, g,
                                         common_args(cfg, workdir))
    for tag, run in dist["paths"].items():
        if isinstance(run, dict):
            launches[tag] = run["counts"]
    torch.cuda.empty_cache()
    with data_workdir() as workdir:
        dataset_paths, ingest = phase_datasets(
            cuda_build, spmm_cuda, gat_cuda, workdir, host, labels, dev, smi)
    launches.update(dataset_paths)
    launches["op_surface"] = op_surface
    t_phase = time.perf_counter()
    children, dry_runs = phase_experiments(native, smi)
    for child in children:
        launches[f"glnn_synth {child['label']}"] = child["launches"]
    traces, traced = phase_traces(cuda_build, spmm_cuda, gat_cuda, host,
                                  labels, idx_train, g, smi)
    launches.update(traced)
    log(f"phase 4d (experiments and traces): "
        f"{time.perf_counter() - t_phase:.1f} s")

    kernels = (phase_times(spmm_cuda, g, launches, errs)
               + phase_times_weighted(spmm_cuda, g, launches, errs)
               + phase_times_f32(spmm_cuda, refops, g, launches, errs)
               + phase_times_gat(gat_cuda, g, launches, errs)
               + phase_times_softmax(gat_cuda, g, launches, errs))
    phase_times_hub(spmm_cuda, gat_cuda, hub, kernels)
    for row in kernels:
        row["hub_graph_max_abs_err"] = hub_errs[row["name"]]
        if row["name"] in bf16_errs:
            row["bf16_x_max_abs_err"] = bf16_errs[row["name"]]
        if row["name"] in ("spmm_csr_bf16", "spmm_csr_int8"):
            row["dataset_widths_max_abs_err"] = width_errs
        if row["name"] == "spmm_csr_bf16":
            row["ogbn_products_f100"] = ingest["ogbn-products"]["spmm_f100"]
        if row["name"] == "spmm_csr_f32":
            row["ogbn_products_f100"] = ingest["ogbn-products"][
                "spmm_f32_f100"]
    log(f"ingest {json.dumps(ingest)}")
    tiers = phase_times_tiers(host, labels, idx_train, g, smi)
    log(f"tier times {json.dumps(tiers)}")
    log(f"sampled SAGE epoch: data-parallel on {N_SHARDS} ranks "
        f"{dist['paths']['sage_epoch']} ({SHARD_CUT_EPOCHS} epochs of the "
        f"CLI run); single "
        f"process floyd/float32 {tiers['sage_epoch_s']['floyd/float32']} s; "
        f"{smi}")
    for model in ("GAT", "APPNP"):
        log(f"{model} epoch: halo-sharded on {N_SHARDS} ranks "
            f"{dist['paths'][f'{model.lower()}_epoch']} ({TEACHER_EPOCHS} "
            f"epochs of the CLI run); single process {EPOCH_LINES[model]}; "
            f"{smi}")
    log(f"distributed {json.dumps(dist)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
