#!/usr/bin/env python3
"""Device and eager times of APPNP's fused weighted walks on the graph of
the benchmark's `arxiv-appnp-teacher` cell, for one checkout of the port.

    python3 tools/time_weighted_walks.py [--root PATH] [--seed N] [--reps 3]

Builds the cell's graph (`gnnbench/configs/appnp-arxiv.json`: ogbn-arxiv's
169,343 nodes and 2,501,829 edges with Redner-law in-degrees) from --seed
and times `spmm_cuda.appnp_wsum` at F = 40 (the logits' width), forward
(`Appnp<0>`) and transposed (`Appnp<1>`, the backward's dX), each with
the graph's kept hub plans (walk and split rows' sum), under two weights:
the cell's edge drop (each edge kept with probability 1/2, weight 2, else
0) and dense weights (every edge 2). Each case is timed --reps times with
chip_smoke.kernel_times (the eager time of calls back to back, and the
device time of CUDA-graph replays) and reported by its median, beside its
bytes bound (gnnbench/models/APPNP.py's count at 3.35 TB/s). --root is the
checkout whose package is timed (by default this one): a parent commit
unpacked into a git-ignored directory compares two versions on one card
in one call. Prints the card's name and power limit, then one JSON line:
{"root", "device_ms": {case: ms}, "ms": {case: ms}, "bound_ms": {case:
ms}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=2400000001)
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))

    import torch

    if not torch.cuda.is_available():
        print("time_weighted_walks: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from glnn_tpu_torch.graph.container import build_graph
    from glnn_tpu_torch.ops import cuda_build, refops, spmm_cuda

    from gnnbench import data, find

    cuda_build.build()
    dev = torch.device("cuda:0")
    ds = json.loads((HERE / "gnnbench" / "configs" / "appnp-arxiv.json")
                    .read_text())["dataset"]
    src, dst = data.make_graph(ds, opts.seed, dev)
    g = build_graph(src.cpu().numpy(), dst.cpu().numpy(),
                    ds["n_nodes"]).to(dev)
    del src, dst
    n, e, f = g.n_nodes, g.n_edges, ds["n_classes"]
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    x, h0 = (torch.randn((n, f), generator=gen, device=dev) for _ in range(2))
    drop = 0.5
    weights = {"drop": (torch.rand(e, generator=gen, device=dev)
                        >= drop).float() / (1.0 - drop),
               "dense": torch.full((e,), 1.0 / (1.0 - drop), device=dev)}
    src_norm, dst_norm = refops.degree_norms(g)
    alpha = 0.1
    appnp = find.module("models", "APPNP")
    bound = {"forward": appnp.weighted_op(n, e, f)[0],
             "transposed": appnp.weighted_t_op(n, e, f)[0]}
    cases = {}
    for tag, w in weights.items():
        cases[f"forward {tag}"] = ("forward", lambda w=w: spmm_cuda.appnp_wsum(
            g, x, w, src_norm, dst_norm, h0, alpha, False))
        cases[f"transposed {tag}"] = ("transposed", lambda w=w: spmm_cuda.appnp_wsum(
            g, x, w, dst_norm, src_norm, None, alpha, True))
    out = {"root": str(root), "device_ms": {}, "ms": {}, "bound_ms": {}}
    for name, (walk, fn) in cases.items():
        times = [cs.kernel_times(fn) for _ in range(opts.reps)]
        out["ms"][name] = statistics.median(t[0] for t in times)
        out["device_ms"][name] = statistics.median(t[1] for t in times)
        out["bound_ms"][name] = bound[walk] / cs.HBM_BYTES_PER_S * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
