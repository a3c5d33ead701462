"""Shared CLI plumbing for the teacher/student entry points
(`glnn_tpu/cli/common.py`): the same flags with the same defaults, and the
same output layout `outputs/transductive/<dataset>/<model>/seed_<s>/` (or
`outputs/inductive/split_rate_<r>/<dataset>/<model>/seed_<s>/`) with `log`
and `out.npz` (with --save_results also `loss_and_score.npz` and
`model.ckpt`), and an append-only `exp_results` (and `min_cut_loss`) one
level up.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                              "train.conf.yaml")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=int, default=0,
                        help="CUDA device ordinal (-1 runs on the CPU)")
    parser.add_argument("--seed", type=int, default=0, help="Random seed")
    parser.add_argument("--log_level", type=int, default=20,
                        help="10: DEBUG, 20: INFO, 30: WARNING")
    parser.add_argument("--console_log", action="store_true",
                        help="Mirror log lines to the console")
    parser.add_argument("--output_path", type=str, default="outputs",
                        help="Path to save outputs")
    parser.add_argument("--num_exp", type=int, default=1,
                        help="Repeat how many experiments")
    parser.add_argument("--exp_setting", type=str, default="tran",
                        help="One of [tran, ind]")
    parser.add_argument("--eval_interval", type=int, default=1,
                        help="Evaluate once per how many epochs")
    parser.add_argument("--save_results", action="store_true",
                        help="Also save loss curves and model checkpoint")
    parser.add_argument("--n_shards", type=int, default=1,
                        help="Ranks to shard over, one process each: the "
                             "GCN, full-batch SAGE, GAT and APPNP teachers "
                             "halo-sharded, the sampled SAGE teacher and the "
                             "MLPs data-parallel; rank r runs on "
                             "cuda:<device + r> (all on cuda:<device> with "
                             "GLNN_SHARE_DEVICE=1) or on the CPU")
    parser.add_argument("--debug_checks", action="store_true",
                        help="Raise on a non-finite epoch loss")
    parser.add_argument("--ops_backend", type=str, default="auto",
                        choices=["auto", "xla", "pallas", "pallas_int8"],
                        help="Message-passing tier: auto, xla (plain f32), "
                             "pallas (exact CUDA kernel: bf16 messages, f32 "
                             "sums) or pallas_int8 (int8 CUDA kernel)")
    parser.add_argument("--exact_eval", action="store_true",
                        help="Keep evals on the exact tier. By default (auto "
                             "backend) intermediate evals on CUDA take the "
                             "int8 tier")
    parser.add_argument("--compile_cache", type=str,
                        default=os.environ.get("GLNN_COMPILE_CACHE",
                                               "~/.cache/glnn_tpu_xla"),
                        help="Kept for flag parity; the port compiles nothing "
                             "ahead of time")

    # dataset
    parser.add_argument("--dataset", type=str, default="cora")
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--labelrate_train", type=int, default=20,
                        help="Labeled nodes per class in the train set")
    parser.add_argument("--labelrate_val", type=int, default=30,
                        help="Labeled nodes per class in the valid set")
    parser.add_argument("--split_idx", type=int, default=0,
                        help="NonHom/BGNN datasets: which fixed split")

    # model
    parser.add_argument("--model_config_path", type=str,
                        default=DEFAULT_CONFIG)
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--hidden_dim", type=int, default=128)
    parser.add_argument("--dropout_ratio", type=float, default=0)
    parser.add_argument("--norm_type", type=str, default="none",
                        help="One of [none, batch, layer]")

    # SAGE specific
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--fan_out", type=str, default="5,5",
                        help="Comma list of per-layer fanouts for sampled SAGE")
    parser.add_argument("--sampler_tier", type=str, default="floyd",
                        choices=["floyd", "window"],
                        help="Neighbour-sampling tier of the sampled SAGE "
                             "teacher: floyd = DGL-exact offsets; window = "
                             "the same offsets folded into each node's "
                             "aligned 64-edge window (equal to floyd for "
                             "in-degrees <= 64; heavier nodes sample from "
                             "their first 64 in-edges)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Activation compute dtype of the SAGE teacher "
                             "and the MLP student (GCN, GAT and APPNP "
                             "ignore it); parameters, norm statistics, "
                             "losses and out.npz stay float32")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Unused (sampling runs on the device); kept for "
                             "flag compatibility")
    parser.add_argument("--sage_sampling", type=str, default="auto",
                        help="SAGE trainer mode: auto|sampled|full "
                             "(full-batch steps)")

    # optimization
    parser.add_argument("--learning_rate", type=float, default=0.01)
    parser.add_argument("--weight_decay", type=float, default=0.0005)
    parser.add_argument("--max_epoch", type=int, default=500)
    parser.add_argument("--patience", type=int, default=50,
                        help="Early stop after this many non-improving evals")

    # ablation
    parser.add_argument("--feature_noise", type=float, default=0,
                        help="Blend features with white noise: (1-a)x + aN")
    parser.add_argument("--split_rate", type=float, default=0.2,
                        help="Inductive split rate")
    parser.add_argument("--compute_min_cut", action="store_true",
                        help="Compute and append the min-cut loss "
                             "(transductive only)")
    parser.add_argument("--feature_aug_k", type=int, default=0,
                        help="GA-MLP: propagate features k hops first")


def resolve_device(ordinal: int) -> torch.device:
    """cuda:<ordinal>, or the CPU for -1. Raises when no such GPU exists:
    the port never carries on quietly on the CPU."""
    if ordinal < 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device -1 "
                           "to run on the CPU")
    if ordinal >= torch.cuda.device_count():
        raise RuntimeError(f"--device {ordinal} is out of range "
                           f"({torch.cuda.device_count()} CUDA device(s))")
    return torch.device(f"cuda:{ordinal}")


def configure_numerics() -> None:
    """Full float32 matrix products: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup_backend(args) -> None:
    from glnn_tpu_torch import ops

    ops.set_backend(args.ops_backend)
    ops.set_eval_quant(not args.exact_eval)


def teacher_output_dir(args, model_name: str) -> Path:
    if args.exp_setting == "tran":
        return Path.cwd().joinpath(args.output_path, "transductive",
                                   args.dataset, model_name,
                                   f"seed_{args.seed}")
    if args.exp_setting == "ind":
        return Path.cwd().joinpath(args.output_path, "inductive",
                                   f"split_rate_{args.split_rate}",
                                   args.dataset, model_name,
                                   f"seed_{args.seed}")
    raise ValueError(f"Unknown experiment setting! {args.exp_setting}")


def apply_output_path_reroutes(args, is_student: bool = False) -> None:
    """Noisy-feature and feature-aug runs get a rerouted output root (seed 0
    only, as in the reference, whose repeat_run mutates the seed after the
    first run). A feature-aug run also prefixes the teacher's or student's
    name with GA<k>, so that the config lookup then finds no row: the
    reference's behaviour, kept."""
    if args.feature_noise != 0 and args.seed == 0:
        args.output_path = str(Path.cwd().joinpath(
            args.output_path, "noisy_features", f"noise_{args.feature_noise}"
        ))
        if is_student:
            args.out_t_path = args.output_path
    if args.feature_aug_k > 0 and args.seed == 0:
        args.output_path = str(Path.cwd().joinpath(
            args.output_path, "aug_features", f"aug_hop_{args.feature_aug_k}"
        ))
        if is_student:
            args.student = f"GA{args.feature_aug_k}{args.student}"
        else:
            args.teacher = f"GA{args.feature_aug_k}{args.teacher}"


def propagate_features(feats, k: int, g, obs_g=None, idx_obs=None):
    """--feature_aug_k: k hops of `feature_prop` of all rows over the device
    graph g; in the inductive setting the obs rows are propagated over the
    observed device graph obs_g instead and written over the full-graph
    ones. Returns numpy f32."""
    from glnn_tpu_torch.ops.graph_utils import feature_prop

    def prop(x, graph):
        x = torch.as_tensor(np.asarray(x, np.float32), device=graph.device)
        return feature_prop(x, graph, k).cpu().numpy()

    out = prop(feats, g)
    if obs_g is not None:
        out[idx_obs] = prop(feats[idx_obs], obs_g)
    return out


def log_launches(logger) -> None:
    """One `launches {...}` line: this process's kernel launches and
    plain-version calls on CUDA tensors so far (the counters are never
    reset here, so with --num_exp a later seed's line counts the earlier
    seeds too)."""
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    logger.info("launches " + json.dumps(
        {**spmm_cuda.counts, **gat_cuda.counts, **cuda_build.counts}))


def save_results(output_dir: Path, loss_and_score, state_out) -> None:
    """--save_results: the loss curves as `loss_and_score.npz` (rows of 7
    fields, 9 inductive) and the best model's state dict as `model.ckpt`."""
    from glnn_tpu_torch.utils.checkpoint import save_model

    np.savez(output_dir.joinpath("loss_and_score"), np.array(loss_and_score))
    save_model(output_dir.joinpath("model.ckpt"), state_out["state_dict"])


def append_min_cut(output_dir: Path, g, out) -> None:
    """--compute_min_cut: append the min-cut loss of the all-node
    log-probs `out` over the device graph g to `min_cut_loss` one level
    above output_dir."""
    from glnn_tpu_torch.ops.graph_utils import compute_min_cut_loss

    loss = float(compute_min_cut_loss(
        g, torch.as_tensor(np.asarray(out), device=g.device)))
    with open(output_dir.parent.joinpath("min_cut_loss"), "a+") as f:
        f.write(f"{loss :.4f}\n")


def add_feature_noise(feats, noise: float, seed: int):
    """Blend features with seeded white noise: (1 - a) x + a N(0, 1)."""
    if 0 < noise <= 1:
        rs = np.random.RandomState(seed)
        feats = ((1 - noise) * feats
                 + noise * rs.randn(*feats.shape).astype(np.float32))
    return feats


def score_line(run, args) -> str:
    """Run `num_exp` seeds and format the score line (mean, then std, when
    more than one)."""
    if args.num_exp == 1:
        return "".join(f"{s : .4f}\t" for s in run(args))
    scores = []
    for seed in range(args.num_exp):
        args.seed = seed
        scores.append(run(args))
    scores = np.array(scores)
    return "".join([f"{s : .4f}\t" for s in scores.mean(axis=0)]
                   + [f"{s : .4f}\t" for s in scores.std(axis=0)])
