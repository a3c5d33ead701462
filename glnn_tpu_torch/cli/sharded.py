"""--n_shards N > 1 in both CLIs (`glnn_tpu/cli/train_teacher.py:44-80`,
`:149-227`, `:242-246`): the parent process loads the data, relabels the
nodes for locality (GNN teachers), builds each shard's halo index sets on
the host once, and launches one rank per shard (`distributed.mesh.launch`)
with only its shard: its feature rows, its HaloGraph, and the replicated
structure graph of a sampled SAGE teacher. Every rank runs the engine's
runner on its shard under a `RankPlacement` (distributed/runners.py);
rank 0 writes `log` (with every rank's backend and device, and the kernel
launches summed over the ranks), `out.npz` (in the original node order)
and the saved results, and returns its scores to the parent, which
prints the score line.

Paths: an MLP teacher and the MLP student train data-parallel; a sampled
SAGE teacher trains data-parallel on the structure graph and evaluates on
the halo graph; GCN, full-batch SAGE, GAT and APPNP train and evaluate on
the halo graph. The GAT and APPNP shards carry their combined CSR (the
per-edge ops' edge order), as JAX builds attention plans for GAT only
(`glnn_tpu/cli/train_teacher.py:156,181`).
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from glnn_tpu_torch import native
from glnn_tpu_torch.cli.common import (
    append_min_cut,
    configure_numerics,
    propagate_features,
    save_results,
)
from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.distributed.halo import (
    build_halo_graph,
    halo_fraction,
    shard_rows,
)
from glnn_tpu_torch.distributed.partition import (
    community_balanced_order,
    inverse_permutation,
    label_propagation_labels,
)
from glnn_tpu_torch.distributed.runners import RankPlacement
from glnn_tpu_torch.graph.host import reorder_nodes
from glnn_tpu_torch.nn.models import APPNP, GAT
from glnn_tpu_torch.utils import graph_split

# the label propagation's edge budget per tier of the host-graph library
# (glnn_tpu/cli/train_teacher.py:44-45): ogbn-products fits the native one
LOCALITY_MAX_EDGES = {"numpy": 20_000_000, "native": 300_000_000}


def locality_relabel(g, feats, labels, idxs, n_shards: int, logger):
    """Community-locality relabeling ahead of the contiguous halo partition:
    label-propagation communities, LPT-assigned whole to equal node blocks.
    Returns (g, feats, labels, idxs, new_id), new_id None when skipped
    (graphs above the tier's LOCALITY_MAX_EDGES); out[new_id] undoes it.
    Logs the tier and its seconds."""
    n = g.num_nodes()
    tier = "native" if native.available() else "numpy"
    if g.num_edges() > LOCALITY_MAX_EDGES[tier]:
        logger.info(f"locality relabel skipped: graph above the {tier} "
                    f"label-propagation tier's budget of "
                    f"{LOCALITY_MAX_EDGES[tier]:,} edges")
        return g, feats, labels, idxs, None
    t0 = time.perf_counter()
    lab = label_propagation_labels(g.src, g.dst, n)
    t1 = time.perf_counter()
    order = community_balanced_order(lab, np.bincount(g.dst, minlength=n),
                                     n_shards)
    new_id = inverse_permutation(order)
    g2 = reorder_nodes(g, order)
    logger.info(f"locality relabel: {tier} label propagation {t1 - t0:.2f} "
                f"s, relabel {time.perf_counter() - t0:.2f} s (host); halo "
                f"edge fraction "
                f"{halo_fraction(g2.src, g2.dst, n, n_shards):.3f} at "
                f"n_shards={n_shards}")
    return (g2, feats[order], labels[order],
            tuple(new_id[np.asarray(i)] for i in idxs), new_id)


def _halo_shards(host_g, n_shards: int, logger, name: str,
                 combined: bool) -> list:
    n = host_g.num_nodes()
    shards = build_halo_graph(host_g.src, host_g.dst, n, n_shards, combined)
    frac = halo_fraction(host_g.src, host_g.dst, n, n_shards)
    logger.info(
        f"halo {name}: {n} nodes, rows {shards[0].rows} per shard, edge "
        f"fraction {frac:.4f}; "
        + "; ".join(f"shard {s.rank}: {s.indices.shape[0]} local edges, "
                    f"{s.halo_indices.shape[0]} halo edges, {s.n_recv} halo "
                    f"rows" for s in shards))
    return shards


def _common(args, conf, model, output_dir) -> dict:
    # the initial weights go to the ranks from host memory: CUDA tensors
    # would cross the processes as IPC handles of the parent's allocations
    return {"conf": conf,
            "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "log": (str(output_dir.joinpath("log")), args.console_log,
                    args.log_level),
            "ops": (args.ops_backend, args.exact_eval),
            "output_dir": str(output_dir), "save_results": args.save_results,
            "setting": args.exp_setting}


def _rank_setup(mesh, payload):
    """(model, optimizer, logger) of a rank; rank 0 logs to the run's log."""
    from glnn_tpu_torch import ops
    from glnn_tpu_torch.nn.models import Model
    from glnn_tpu_torch.train import make_adam
    from glnn_tpu_torch.utils import get_logger, set_seed

    conf = payload["conf"]
    set_seed(int(conf["seed"]))
    configure_numerics()
    backend, exact_eval = payload["ops"]
    ops.set_backend(backend)
    ops.set_eval_quant(not exact_eval)
    if mesh.rank == 0:
        logger = get_logger(*payload["log"])
    else:
        logger = logging.getLogger(f"glnn_tpu_torch.rank{mesh.rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    places = [None] * mesh.size
    torch.distributed.all_gather_object(places, (mesh.backend,
                                                 str(mesh.device)))
    for r, (backend, device) in enumerate(places):
        logger.info(f"rank {r} of {mesh.size}: backend {backend}, device "
                    f"{device}")
    model = Model(conf).to(mesh.device)
    model.load_state_dict(payload["state"])
    optimizer = make_adam(model.parameters(), conf["learning_rate"],
                          conf["weight_decay"])
    return model, optimizer, logger


def _log_launches(mesh, logger) -> None:
    """One `launches {...}` line: every kernel's launches summed over the
    ranks, and the plain-version calls on CUDA tensors."""
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    counts = {k: v for m in (spmm_cuda, gat_cuda, cuda_build)
              for k, v in m.counts.items()}
    total = torch.tensor(list(counts.values()), dtype=torch.int64,
                         device=mesh.device)
    _mesh.all_reduce_(total)
    logger.info("launches " + json.dumps(dict(zip(counts, total.tolist()))))


def _finish(mesh, logger, payload, out, scores, loss_and_score, state_out,
            unmap=None):
    """Rank 0 writes out.npz (original node order) and the saved results."""
    from pathlib import Path

    _log_launches(mesh, logger)
    if mesh.rank != 0:
        return None
    conf = payload["conf"]
    logger.info(
        f"num_layers: {conf['num_layers']}. hidden_dim: "
        f"{conf['hidden_dim']}. dropout_ratio: {conf['dropout_ratio']}")
    output_dir = Path(payload["output_dir"])
    np.savez(output_dir.joinpath("out"), out if unmap is None else out[unmap])
    if payload["save_results"]:
        save_results(output_dir, loss_and_score, state_out)
    return {"scores": scores, "out": out}


def teacher_rank(mesh, payload):
    """One rank of a sharded teacher run."""
    from glnn_tpu_torch.train import run_inductive, run_transductive

    model, optimizer, logger = _rank_setup(mesh, payload)
    dev = mesh.device
    conf = payload["conf"]
    g, obs_g, struct = (payload[k].to(dev) if payload[k] is not None
                        else None for k in ("g", "obs_g", "g_struct"))
    place = RankPlacement(struct, payload["obs_feats"])
    loss_and_score = []
    state_out = {} if payload["save_results"] else None
    if payload["setting"] == "tran":
        out, _, *scores = run_transductive(
            conf, model, g, payload["feats"], payload["labels"],
            payload["indices"], optimizer, logger, loss_and_score, dev,
            state_out, place)
    else:
        out, _, *scores = run_inductive(
            conf, model, g, obs_g, payload["feats"], payload["labels"],
            payload["indices"], optimizer, logger, loss_and_score, dev,
            state_out, place)
    return _finish(mesh, logger, payload, out, scores, loss_and_score,
                   state_out, payload["unmap"])


def run_teacher(args, conf, model, g, feats, labels, idxs, logger,
                output_dir, device):
    """The sharded teacher, from the parent process; returns the scores."""
    from glnn_tpu_torch.train.engine import _use_sampled_sage

    n_shards = int(conf["n_shards"])
    logger.info(f"distributed: n_shards={n_shards}")
    unmap = None
    if not model.is_mlp:
        g, feats, labels, idxs, unmap = locality_relabel(
            g, feats, labels, idxs, n_shards, logger)
    sampled = _use_sampled_sage(conf, model)
    window = conf.get("sampler_tier") == "window" and sampled
    per_edge = isinstance(model.module, (GAT, APPNP))
    graph = (g.to_device(device) if args.feature_aug_k > 0
             or (args.compute_min_cut and args.exp_setting == "tran")
             else None)
    common = _common(args, conf, model, output_dir)
    common["unmap"] = unmap
    per_rank = [dict(common, g=None, obs_g=None, g_struct=None,
                     obs_feats=None) for _ in range(n_shards)]
    if args.exp_setting == "tran":
        if args.feature_aug_k > 0:
            feats = propagate_features(feats, args.feature_aug_k, graph)
        if not model.is_mlp:
            for r, s in enumerate(_halo_shards(g, n_shards, logger, "graph",
                                               per_edge)):
                per_rank[r]["g"] = s
        struct = g.to_device("cpu", window_table=window) if sampled else None
        indices = tuple(idxs)
    else:
        indices = graph_split(*idxs, args.split_rate, args.seed)
        if unmap is not None:
            # obs-local ids follow idx_obs's order: sorting idx_obs carries
            # the relabeling's locality into the observed graph's partition
            obs_tr, obs_va, obs_te, idx_obs, idx_ind = indices
            order_obs = np.argsort(idx_obs, kind="stable")
            pos = inverse_permutation(order_obs)
            indices = (pos[np.asarray(obs_tr)], pos[np.asarray(obs_va)],
                       pos[np.asarray(obs_te)], idx_obs[order_obs], idx_ind)
        obs_host = g.subgraph(indices[3])
        if args.feature_aug_k > 0:
            feats = propagate_features(feats, args.feature_aug_k, graph,
                                       obs_host.to_device(device), indices[3])
        if not model.is_mlp:
            logger.info(f"Observed graph: {obs_host.num_nodes()} nodes, "
                        f"{obs_host.num_edges()} edges.")
            full = _halo_shards(g, n_shards, logger, "graph", per_edge)
            obs = _halo_shards(obs_host, n_shards, logger, "observed graph",
                               per_edge)
            obs_feats = feats[indices[3]]
            for r in range(n_shards):
                per_rank[r].update(
                    g=full[r], obs_g=obs[r],
                    obs_feats=shard_rows(obs_feats, n_shards, r))
        struct = (obs_host.to_device("cpu", window_table=window) if sampled
                  else None)
    for r in range(n_shards):
        per_rank[r].update(feats=shard_rows(feats, n_shards, r),
                           labels=labels, indices=indices, g_struct=struct)
    result = _mesh.launch(teacher_rank, per_rank, args.device)
    if args.exp_setting == "tran" and args.compute_min_cut:
        append_min_cut(output_dir, graph, result["out"])
    return result["scores"]


def student_rank(mesh, payload):
    """One rank of a sharded student run."""
    from glnn_tpu_torch.train import (distill_run_inductive,
                                      distill_run_transductive)

    model, optimizer, logger = _rank_setup(mesh, payload)
    run = (distill_run_transductive if payload["setting"] == "tran"
           else distill_run_inductive)
    loss_and_score = []
    state_out = {} if payload["save_results"] else None
    out, _, *scores = run(payload["conf"], model, payload["feats"],
                          payload["labels"], payload["out_t"],
                          payload["indices"], optimizer, logger,
                          loss_and_score, mesh.device, state_out,
                          RankPlacement())
    return _finish(mesh, logger, payload, out, scores, loss_and_score,
                   state_out)


def run_student(args, conf, model, feats, labels, out_t, indices, logger,
                output_dir):
    """The data-parallel student, from the parent process; feats already
    propagated (--feature_aug_k). Returns (scores, out)."""
    n_shards = int(conf["n_shards"])
    logger.info(f"distributed: n_shards={n_shards} data-parallel")
    common = dict(_common(args, conf, model, output_dir), labels=labels,
                  indices=indices)
    per_rank = [dict(common, feats=shard_rows(feats, n_shards, r),
                     out_t=shard_rows(np.asarray(out_t, np.float32), n_shards,
                                      r)) for r in range(n_shards)]
    result = _mesh.launch(student_rank, per_rank, args.device)
    return result["scores"], result["out"]
