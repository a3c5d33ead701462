#!/usr/bin/env python3
"""Device and eager times of the kernels that split hub rows across warps,
on the synth graph and on the hub graph, for one checkout of the port.

    python3 tools/hub_kernel_times.py [--root PATH] [--reps 3]

Times `spmm_csr_bf16`, `spmm_csr_int8` and `spmm_csr_weighted` at F = 40
(the GCN and APPNP width; the weighted sum with APPNP's {0, 2} keep
weights, forward walk), `gat_fwd` and `gat_bwd` at both of chip_smoke.py's
GAT shapes (dropout in seed mode) and `edge_softmax_fwd` and
`edge_softmax_bwd` on [E, 8] and [E, 1] scores, each on chip_smoke.py's
synth graph
(synth-n169343-c40-f128-d7) and on its hub graph (the same N and E, rows
of up to 20,000 edges), with chip_smoke.kernel_times: the eager time of
calls back to back, and the device time of CUDA-graph replays. --root is
the checkout whose package and chip_smoke.py are timed (by default this
one): a parent commit unpacked into a git-ignored directory compares two
versions on one card in one call (run parent, change, change, parent).
A wrapper that takes a hub plan (a `plan` parameter) gets the graph's
kept plan (`spmm_cuda.plan_of`), as its paths give it: the GAT kernels
the GAT layer's (T = `gat_cuda.GAT_CHUNK` where the package has one, else
`spmm_cuda.HUB_CHUNK`), the others HUB_CHUNK's; an older one is called as
its paths call it. Each case is timed --reps times and reported by its
median.
Prints the card's name and power limit, then one JSON line: {"root",
"device_ms": {case: ms}, "ms": {case: ms}}.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("hub_kernel_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from glnn_tpu_torch.graph.datasets import load_synth_data
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    cuda_build.build()
    dev = torch.device("cuda:0")
    host, *_ = load_synth_data(cs.DATASET, 0, cs.LABELRATE_TRAIN,
                               cs.LABELRATE_VAL)
    g = host.to_device(dev)
    graphs = {"synth": g, "hub": cs.hub_graph(g.n_nodes, g.n_edges,
                                              9).to(dev)}
    kept = hasattr(spmm_cuda, "plan_of")

    def plan_kw(fn, plan):
        """{"plan": plan} where fn takes one."""
        return ({"plan": plan[0]} if plan
                and "plan" in inspect.signature(fn).parameters else {})

    cases = {}
    for tag, gr in graphs.items():
        n, e, f = gr.n_nodes, gr.n_edges, cs.APPNP_F
        gen = torch.Generator(device=dev).manual_seed(10)
        x = torch.randn((n, f), generator=gen, device=dev)
        xb = spmm_cuda.to_message(x)
        q, s = spmm_cuda.quantize_cols(x)
        w = (torch.rand(e, generator=gen, device=dev)
             >= cs.EDGE_DROP).float() / (1.0 - cs.EDGE_DROP)
        plan = (spmm_cuda.plan_of(gr, "indptr", n),) if kept else ()
        gat_plan = ((spmm_cuda.plan_of(gr, "indptr", n, getattr(
            gat_cuda, "GAT_CHUNK", spmm_cuda.HUB_CHUNK)),) if kept else ())
        fwd_plan = plan_kw(gat_cuda.gat_fwd, gat_plan)
        bwd_plan = plan_kw(gat_cuda.gat_bwd, gat_plan)
        smx_plan = plan_kw(gat_cuda.edge_softmax_fwd, plan)
        smx_bwd_plan = plan_kw(gat_cuda.edge_softmax_bwd, plan)
        cases[f"{tag} spmm_csr_bf16 F={f}"] = (
            lambda gr=gr, xb=xb, p=plan: spmm_cuda.csr_sum_bf16(
                gr.indptr, gr.senders, xb, gr.n_nodes, *p))
        cases[f"{tag} spmm_csr_int8 F={f}"] = (
            lambda gr=gr, q=q, s=s, p=plan: spmm_cuda.csr_sum_int8(
                gr.indptr, gr.senders, q, s, gr.n_nodes, *p))
        cases[f"{tag} spmm_csr_weighted F={f}"] = (
            lambda gr=gr, x=x, w=w, p=plan: spmm_cuda.csr_wsum_bf16(
                gr.indptr, gr.senders, None, x, w, gr.n_nodes, *p))
        for h, d in cs.GAT_SHAPES:
            args, dout, al_b = cs.gat_inputs(gat_cuda, gr, h, d,
                                             cs.ATTN_DROP, 11)
            cases[f"{tag} gat_fwd ({h}, {d})"] = (
                lambda a=args, k=fwd_plan: gat_cuda.gat_fwd(*a, **k))
            _, smax, denom = gat_cuda.gat_fwd(*args, **fwd_plan)
            cases[f"{tag} gat_bwd ({h}, {d})"] = (
                lambda a=args + (smax, denom, dout, al_b), k=bwd_plan:
                gat_cuda.gat_bwd(*a, **k))
            scores = 3.0 * torch.randn((e, h), generator=gen, device=dev)
            cases[f"{tag} edge_softmax_fwd [E, {h}]"] = (
                lambda gr=gr, sc=scores, k=smx_plan: gat_cuda.edge_softmax_fwd(
                    gr.indptr, sc, gr.n_nodes, **k))
            alpha = gat_cuda.edge_softmax_fwd(gr.indptr, scores, n,
                                              **smx_plan)
            dalpha = torch.randn((e, h), generator=gen, device=dev)
            cases[f"{tag} edge_softmax_bwd [E, {h}]"] = (
                lambda gr=gr, a=alpha, da=dalpha, k=smx_bwd_plan:
                gat_cuda.edge_softmax_bwd(gr.indptr, a, da, gr.n_nodes, **k))
    times = {name: [] for name in cases}
    for _ in range(opts.reps):
        for name, fn in cases.items():
            times[name].append(cs.kernel_times(fn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({
        "root": str(root),
        "device_ms": {k: statistics.median(d for _, d in v)
                      for k, v in times.items()},
        "ms": {k: statistics.median(m for m, _ in v)
               for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
