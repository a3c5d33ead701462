#!/usr/bin/env python3
"""Per-epoch wall times of a full-batch teacher of the port on one GPU.

    python3 tools/epoch_times.py [--root PATH] [--teacher GAT] [--epochs 15]

Runs the teacher CLI of the port found under --root (by default this
checkout; another checkout, such as a parent commit unpacked into a
git-ignored directory, compares two versions in one run) on
chip_smoke.py's main-path configuration: synth-n169343-c40-f128-d7 at
ogbn-arxiv's split sizes and the published synth row of the teacher
(train.conf.yaml), with an eval after every epoch. The kernels are built
before the run. The training log gives only the mean epoch time; this
records every epoch's time instead (the StepTimer span: one training step,
ended by reading its loss back to the host), so the first epoch, which
holds one-time costs, can be told apart from the steady ones. Prints the
card's name and power limit, then one JSON line: {"root", "teacher",
"epoch_ms": [...], "mean_ms": x, "mean_ms_after_first": x}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--teacher", default="GAT")
    ap.add_argument("--epochs", type=int, default=15)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("epoch_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from glnn_tpu_torch.cli import train_teacher
    from glnn_tpu_torch.ops import cuda_build
    from glnn_tpu_torch.train import engine

    epoch_s = []

    class Recorder(engine.StepTimer):
        def __exit__(self, *exc):
            epoch_s.append(time.perf_counter() - self._t0)
            return super().__exit__(*exc)

    engine.StepTimer = Recorder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    with tempfile.TemporaryDirectory() as workdir:
        cfg = os.path.join(workdir, "arxiv.conf.yaml")
        chip_smoke._config_yaml(cfg)
        train_teacher.main([
            "--device", "0", "--dataset", chip_smoke.DATASET,
            "--eval_interval", "1",
            "--labelrate_train", str(chip_smoke.LABELRATE_TRAIN),
            "--labelrate_val", str(chip_smoke.LABELRATE_VAL),
            "--model_config_path", cfg, "--output_path",
            os.path.join(workdir, "outputs"), "--teacher", opts.teacher,
            "--max_epoch", str(opts.epochs)])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ms = [t * 1e3 for t in epoch_s]
    print(smi)
    print(json.dumps({
        "root": str(root), "teacher": opts.teacher, "epoch_ms": ms,
        "mean_ms": sum(ms) / len(ms),
        "mean_ms_after_first": sum(ms[1:]) / max(len(ms) - 1, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
