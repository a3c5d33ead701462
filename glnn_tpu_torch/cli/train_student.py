"""Student CLI: distil a teacher's soft labels into a graph-free MLP
(`glnn_tpu/cli/train_student.py`).

    python -m glnn_tpu_torch.cli.train_student --teacher SAGE --student MLP \
        --dataset synth-n512-c5-f32-d8-noise3.0 [--device -1]

Reads the teacher's `out.npz` from the same path scheme rooted at
--out_t_path (a teacher of either package will do), then runs
distill_run_transductive, or distill_run_inductive with the soft labels of
the observed nodes only (--exp_setting ind, --split_rate). Default --lamb 0
is pure distillation (the hard-label pass still runs, scaled to zero). The
student is graph-free: the graph is built on the device only for
--feature_aug_k and --compute_min_cut (tran). --n_shards N > 1 trains it
data-parallel on N ranks (cli/sharded.py).
"""

from __future__ import annotations

import argparse
import copy

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
from glnn_tpu_torch.graph.datasets import load_data, load_out_t
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.train import (
    distill_run_inductive,
    distill_run_transductive,
    make_adam,
)
from glnn_tpu_torch.utils import (
    check_readable,
    check_writable,
    get_evaluator,
    get_logger,
    get_training_config,
    graph_split,
    set_seed,
)
from glnn_tpu_torch.utils.config import merge_args_with_config


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="GLNN student (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--teacher", type=str, default="SAGE",
                        help="Teacher whose outputs to distill from")
    parser.add_argument("--student", type=str, default="MLP",
                        help="Student model")
    parser.add_argument("--lamb", type=float, default=0,
                        help="Hard-label loss weight in [0,1]; soft gets 1-lamb")
    parser.add_argument("--out_t_path", type=str, default="outputs",
                        help="Path to load teacher outputs")
    return parser.parse_args(argv)


def run(args):
    set_seed(args.seed)
    device = resolve_device(args.device)
    configure_numerics()
    setup_backend(args)

    apply_output_path_reroutes(args, is_student=True)
    output_dir = teacher_output_dir(args, f"{args.teacher}_{args.student}")
    t_args = copy.copy(args)
    t_args.output_path = args.out_t_path
    out_t_dir = teacher_output_dir(t_args, args.teacher)
    args.output_dir = output_dir

    check_writable(output_dir, overwrite=False)
    check_readable(out_t_dir)
    logger = get_logger(output_dir.joinpath("log"), args.console_log,
                        args.log_level)
    logger.info(f"output_dir: {output_dir}")
    logger.info(f"out_t_dir: {out_t_dir}")
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
        conf = get_training_config(args.model_config_path, args.student,
                                   args.dataset)
    conf = merge_args_with_config(dict(args.__dict__), conf, logger)
    logger.info(f"conf: { {k: v for k, v in conf.items() if k != 'output_dir'} }")

    model = Model(conf, gen=torch.Generator().manual_seed(args.seed)).to(device)
    optimizer = make_adam(model.parameters(), conf["learning_rate"],
                          conf["weight_decay"])
    evaluator = get_evaluator(conf["dataset"])

    out_t = load_out_t(out_t_dir)
    for name, idx in (("train", idx_train), ("val", idx_val),
                      ("test", idx_test)):
        logger.debug(f"teacher score on {name} data: "
                     f"{evaluator(out_t[idx], labels[idx])}")

    loss_and_score = []
    state_out = {} if args.save_results else None
    min_cut = args.compute_min_cut and args.exp_setting == "tran"
    graph = (g.to_device(device) if args.feature_aug_k > 0 or min_cut
             else None)
    if args.exp_setting == "tran":
        idx_t = np.concatenate([idx_train, idx_val, idx_test])
        indices = (idx_train, idx_t, idx_val, idx_test)
        if args.feature_aug_k > 0:
            feats = propagate_features(feats, args.feature_aug_k, graph)
        runner = distill_run_transductive
    else:   # "ind" (teacher_output_dir rejected any other setting)
        obs_idx_train, obs_idx_val, obs_idx_test, idx_obs, idx_test_ind = (
            graph_split(idx_train, idx_val, idx_test, args.split_rate,
                        args.seed))
        obs_idx_t = np.concatenate([obs_idx_train, obs_idx_val, obs_idx_test])
        indices = (obs_idx_train, obs_idx_t, obs_idx_val, obs_idx_test,
                   idx_obs, idx_test_ind)
        if args.feature_aug_k > 0:
            feats = propagate_features(
                feats, args.feature_aug_k, graph,
                g.subgraph(idx_obs).to_device(device), idx_obs)
        runner = distill_run_inductive
    if int(conf.get("n_shards") or 1) > 1:
        score_lst, out = sharded.run_student(args, conf, model, feats, labels,
                                             out_t, indices, logger,
                                             output_dir)
        if min_cut:
            append_min_cut(output_dir, graph, out)
        return score_lst
    out, _, *score_lst = runner(conf, model, feats, labels, out_t, indices,
                                optimizer, logger, loss_and_score, device,
                                state_out)

    logger.info(
        f"num_layers: {conf['num_layers']}. hidden_dim: "
        f"{conf['hidden_dim']}. dropout_ratio: {conf['dropout_ratio']}"
    )
    log_launches(logger)
    np.savez(output_dir.joinpath("out"), out)
    if args.save_results:
        save_results(output_dir, loss_and_score, state_out)
    if min_cut:
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
