"""Teacher CLI: train a SAGE, GCN, GAT, APPNP or MLP teacher and dump its
soft labels (`glnn_tpu/cli/train_teacher.py`).

    python -m glnn_tpu_torch.cli.train_teacher --teacher SAGE \
        --dataset synth-n512-c5-f32-d8-noise3.0 [--device -1]
    python -m glnn_tpu_torch.cli.train_teacher --teacher APPNP \
        --dataset synth-n512-c5-f32-d8-noise3.0 [--device -1]
    python -m glnn_tpu_torch.cli.train_teacher --teacher SAGE \
        --dataset ogbn-arxiv --data_path data [--device -1]

Every dataset of `graph/datasets.py` loads from its files under
--data_path: CPF npz (cora, ...), OGB `<name>.graph.npz`, NonHom `.mat`
with fixed splits (--split_idx), BGNN CSVs; `synth-*` needs no file.

SAGE trains on fanout-sampled minibatches (full-batch with
--sage_sampling full; --sampler_tier window reads each node's aligned
64-edge window); GCN, GAT and APPNP train full-batch. --compute_dtype
bfloat16 runs SAGE and MLP activations in bf16.

Pipeline: seed -> output dir -> load data -> optional feature noise ->
YAML config merge (YAML beats CLI) -> Model + Adam -> optional feature
propagation (--feature_aug_k) -> run_transductive, or run_inductive on the
observed subgraph (--exp_setting ind, --split_rate) -> `out.npz` all-node
log-probs (+ --save_results curves and checkpoint, + --compute_min_cut in
tran); `--num_exp` aggregates mean/std into `exp_results`. Runs on
cuda:<--device>, or on the CPU with --device -1. --n_shards N > 1 runs N
ranks (cli/sharded.py): GCN, full-batch SAGE, GAT and APPNP halo-sharded,
sampled SAGE and MLP data-parallel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from glnn_tpu_torch import native
from glnn_tpu_torch.cli import sharded
from glnn_tpu_torch.cli.common import (
    add_common_args,
    add_feature_noise,
    append_min_cut,
    apply_output_path_reroutes,
    configure_numerics,
    log_launches,
    propagate_features,
    resolve_device,
    save_results,
    score_line,
    setup_backend,
    teacher_output_dir,
)
from glnn_tpu_torch.graph.datasets import load_data
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.train import make_adam, run_inductive, run_transductive
from glnn_tpu_torch.train.engine import _use_sampled_sage
from glnn_tpu_torch.utils import (
    check_writable,
    get_logger,
    get_training_config,
    graph_split,
    set_seed,
)
from glnn_tpu_torch.utils.config import merge_args_with_config


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="GLNN teacher (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--teacher", type=str, default="SAGE",
                        help="Teacher model: SAGE, GCN, GAT, APPNP or MLP")
    return parser.parse_args(argv)


def run(args):
    """Train one teacher; returns the score list ([score_test] in tran,
    [score_test_tran, score_test_ind] in ind)."""
    set_seed(args.seed)
    device = resolve_device(args.device)
    configure_numerics()
    setup_backend(args)

    apply_output_path_reroutes(args)
    output_dir = teacher_output_dir(args, args.teacher)
    args.output_dir = output_dir
    check_writable(output_dir, overwrite=False)
    logger = get_logger(output_dir.joinpath("log"), args.console_log,
                        args.log_level)
    logger.info(f"output_dir: {output_dir}")
    logger.info(f"device: {device}")
    logger.info(f"host graph ops: {native.describe()}")

    g, labels, idx_train, idx_val, idx_test = load_data(
        args.dataset, args.data_path, split_idx=args.split_idx,
        seed=args.seed, labelrate_train=args.labelrate_train,
        labelrate_val=args.labelrate_val,
    )
    logger.info(f"Total {g.number_of_nodes()} nodes.")
    logger.info(f"Total {g.number_of_edges()} edges.")

    feats = add_feature_noise(np.asarray(g.ndata["feat"], np.float32),
                              args.feature_noise, args.seed)
    args.feat_dim = feats.shape[1]
    args.label_dim = int(labels.max()) + 1

    conf = {}
    if args.model_config_path is not None:
        conf = get_training_config(args.model_config_path, args.teacher,
                                   args.dataset)
    conf = merge_args_with_config(dict(args.__dict__), conf, logger)
    logger.info(f"conf: { {k: v for k, v in conf.items() if k != 'output_dir'} }")

    model = Model(conf, gen=torch.Generator().manual_seed(args.seed)).to(device)
    if int(conf.get("n_shards") or 1) > 1:
        return sharded.run_teacher(args, conf, model, g, feats, labels,
                                   (idx_train, idx_val, idx_test), logger,
                                   output_dir, device)
    optimizer = make_adam(model.parameters(), conf["learning_rate"],
                          conf["weight_decay"])
    # an MLP teacher needs the graph only to propagate features or for the
    # min-cut loss; the window tier of a sampled SAGE teacher reads the
    # aligned window table, on the full and the observed graph
    uses_graph = not model.is_mlp or args.feature_aug_k > 0
    want_win1 = (conf.get("sampler_tier") == "window"
                 and _use_sampled_sage(conf, model))
    graph = (g.to_device(device, window_table=want_win1)
             if uses_graph or args.compute_min_cut else None)

    loss_and_score = []
    state_out = {} if args.save_results else None
    if args.exp_setting == "tran":
        if args.feature_aug_k > 0:
            feats = propagate_features(feats, args.feature_aug_k, graph)
        out, score_val, score_test = run_transductive(
            conf, model, graph, feats, labels, (idx_train, idx_val, idx_test),
            optimizer, logger, loss_and_score, device, state_out)
        score_lst = [score_test]
    else:   # "ind" (teacher_output_dir rejected any other setting)
        indices = graph_split(idx_train, idx_val, idx_test, args.split_rate,
                              args.seed)
        obs_graph = (g.subgraph(indices[3]).to_device(
            device, window_table=want_win1) if uses_graph else None)
        if obs_graph is not None:
            logger.info(f"Observed graph: {obs_graph.n_nodes} nodes, "
                        f"{obs_graph.n_edges} edges.")
        if args.feature_aug_k > 0:
            feats = propagate_features(feats, args.feature_aug_k, graph,
                                       obs_graph, indices[3])
        out, score_val, score_test_tran, score_test_ind = run_inductive(
            conf, model, graph, obs_graph, feats, labels, indices, optimizer,
            logger, loss_and_score, device, state_out)
        score_lst = [score_test_tran, score_test_ind]

    logger.info(
        f"num_layers: {conf['num_layers']}. hidden_dim: "
        f"{conf['hidden_dim']}. dropout_ratio: {conf['dropout_ratio']}"
    )
    log_launches(logger)
    np.savez(output_dir.joinpath("out"), out)
    if args.save_results:
        save_results(output_dir, loss_and_score, state_out)
    if args.exp_setting == "tran" and args.compute_min_cut:
        append_min_cut(output_dir, graph, out)
    return score_lst


def main(argv=None):
    args = get_args(argv)
    score_str = score_line(run, args)
    with open(args.output_dir.parent.joinpath("exp_results"), "a+") as f:
        f.write(f"{score_str}\n")
    print(score_str)


if __name__ == "__main__":
    main()
