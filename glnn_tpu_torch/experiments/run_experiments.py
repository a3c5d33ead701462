"""Paper-reproduction and ablation experiments on the port's CLIs
(`experiments/run_experiments.py`, which drives the JAX CLIs).

Each experiment loops over settings x datasets x models, runs
`python -m glnn_tpu_torch.cli.train_teacher` or `train_student` once per
case with the same flags in the same order as the JAX script, and appends
each child's score row (its last stdout line) to the experiment's text
file as `label<TAB>row`. The paper's hyperparameters: `--num_exp 10
--max_epoch 200 --patience 50`, except ogbn-products (teacher max_epoch 40,
patience 10; student patience 30).

    python -m glnn_tpu_torch.experiments.run_experiments glnn_synth
    python -m glnn_tpu_torch.experiments.run_experiments sage_cpf \
        --data_path data [--device -1] [--dry_run]

Experiments: sage_cpf, glnn_cpf, sage_arxiv, glnn_arxiv, sage_products,
glnn_products, ga_glnn_arxiv, ablation_gnn, ablation_feature_noise,
ablation_ind_split_rate, glnn_synth (offline: synthetic graphs). The CLIs
run on cuda:0 unless --device says otherwise (-1: the CPU). A child that
fails stops the run: its stderr is printed and the exit names the command.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

# the directory that holds the glnn_tpu_torch package
PACKAGE_PARENT = Path(__file__).resolve().parents[2]
CPF = ["cora", "citeseer", "pubmed", "a-computer", "a-photo"]
SYNTH = ["synth-n2048-c7-f128-d10-noise3.0"]
STD = dict(num_exp=10, max_epoch=200, patience=50)
ABL = dict(num_exp=5, max_epoch=200, patience=50)


def child_env() -> dict:
    """This process's environment with the package's parent first on
    PYTHONPATH, so a child started from any work directory imports the
    same glnn_tpu_torch (and reuses its kernels built under the repo)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_PARENT)] + ([env["PYTHONPATH"]]
                                 if env.get("PYTHONPATH") else []))
    return env


@dataclasses.dataclass
class Harness:
    """How the experiments run their CLI children: `extra` flags go to
    every child ahead of the experiment's own; `dry_run` prints each
    command and starts none."""
    extra: dict = dataclasses.field(default_factory=dict)
    dry_run: bool = False

    def _run(self, cli: str, out_file: str | None, label: str | None,
             **flags) -> None:
        flags = dict(self.extra, **flags)
        cmd = [sys.executable, "-m", f"glnn_tpu_torch.cli.{cli}"]
        for k, v in flags.items():
            cmd += [f"--{k}", str(v)]
        print("+", " ".join(cmd), flush=True)
        if self.dry_run:
            return
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             env=child_env())
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            raise SystemExit(f"command failed: {' '.join(cmd)}")
        row = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
        if out_file:
            with open(out_file, "a") as f:
                if label:
                    f.write(f"{label:>12}\t")
                f.write(row + "\n")
        print(row, flush=True)
        print(f"= {seconds:.2f} s", flush=True)

    def teacher(self, **kw) -> None:
        self._run("train_teacher", kw.pop("out_file", None),
                  kw.pop("label", None), **kw)

    def student(self, **kw) -> None:
        self._run("train_student", kw.pop("out_file", None),
                  kw.pop("label", None), **kw)


def sage_cpf(h: Harness, datasets):
    for e in ("tran", "ind"):
        for ds in datasets:
            h.teacher(exp_setting=e, teacher="SAGE", dataset=ds,
                      out_file="sage_cpf.txt", label=f"{e}/{ds}", **STD)


def glnn_cpf(h: Harness, datasets):
    for e in ("tran", "ind"):
        for ds in datasets:
            h.student(exp_setting=e, teacher="SAGE", dataset=ds,
                      out_file="glnn_cpf.txt", label=f"{e}/{ds}", **STD)


def sage_arxiv(h: Harness, _):
    for e in ("tran", "ind"):
        h.teacher(exp_setting=e, teacher="SAGE", dataset="ogbn-arxiv", **STD)


def glnn_arxiv(h: Harness, _):
    for e in ("tran", "ind"):
        h.student(exp_setting=e, teacher="SAGE", student="MLP3w4",
                  dataset="ogbn-arxiv", **STD)


def sage_products(h: Harness, _):
    for e in ("tran", "ind"):
        h.teacher(exp_setting=e, teacher="SAGE", dataset="ogbn-products",
                  num_exp=10, max_epoch=40, patience=10)


def glnn_products(h: Harness, _):
    for e in ("tran", "ind"):
        h.student(exp_setting=e, teacher="SAGE", student="MLP3w8",
                  dataset="ogbn-products", num_exp=10, max_epoch=200,
                  patience=30)


def ga_glnn_arxiv(h: Harness, _):
    h.teacher(exp_setting="ind", teacher="MLP3w4", dataset="ogbn-arxiv",
              feature_aug_k=1, **ABL)
    h.student(exp_setting="ind", teacher="SAGE", student="MLP3w4",
              dataset="ogbn-arxiv", feature_aug_k=1, **ABL)


def ablation_gnn(h: Harness, datasets):
    for e in ("tran", "ind"):
        for t in ("GCN", "GAT", "SAGE", "MLP", "APPNP"):
            for ds in datasets:
                h.teacher(exp_setting=e, teacher=t, dataset=ds,
                          out_file="ablation_gnn.txt",
                          label=f"{e}/{t}/{ds}", **ABL)
                if t != "MLP":
                    h.student(exp_setting=e, teacher=t, dataset=ds,
                              out_file="ablation_gnn.txt",
                              label=f"{e}/{t}+MLP/{ds}", **ABL)


def ablation_feature_noise(h: Harness, datasets):
    for n in [round(0.1 * i, 1) for i in range(1, 11)]:
        for ds in datasets:
            h.teacher(exp_setting="ind", teacher="SAGE", dataset=ds,
                      feature_noise=n, out_file="ablation_feature_noise.txt",
                      label=f"n={n}/{ds}", **ABL)
            h.student(exp_setting="ind", teacher="SAGE", dataset=ds,
                      feature_noise=n, out_file="ablation_feature_noise.txt",
                      label=f"n={n}/{ds}+MLP", **ABL)


def ablation_ind_split_rate(h: Harness, datasets):
    for r in [round(0.1 * i, 1) for i in range(1, 10)]:
        for ds in datasets:
            h.teacher(exp_setting="ind", teacher="SAGE", dataset=ds,
                      split_rate=r, out_file="ablation_ind_split_rate.txt",
                      label=f"r={r}/{ds}", **ABL)
            h.student(exp_setting="ind", teacher="SAGE", dataset=ds,
                      split_rate=r, out_file="ablation_ind_split_rate.txt",
                      label=f"r={r}/{ds}+MLP", **ABL)


def glnn_synth(h: Harness, datasets):
    """Offline smoke reproduction on planted-partition graphs."""
    ds_list = datasets if datasets != CPF else SYNTH
    for e in ("tran", "ind"):
        for ds in ds_list:
            h.teacher(exp_setting=e, teacher="SAGE", dataset=ds, num_exp=2,
                      max_epoch=50, patience=20, out_file="glnn_synth.txt",
                      label=f"{e}/{ds}/SAGE")
            h.student(exp_setting=e, teacher="SAGE", dataset=ds, num_exp=2,
                      max_epoch=50, patience=20, out_file="glnn_synth.txt",
                      label=f"{e}/{ds}/GLNN")


EXPERIMENTS = {f.__name__: f for f in [
    sage_cpf, glnn_cpf, sage_arxiv, glnn_arxiv, sage_products,
    glnn_products, ga_glnn_arxiv, ablation_gnn, ablation_feature_noise,
    ablation_ind_split_rate, glnn_synth,
]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("experiment", choices=sorted(EXPERIMENTS))
    p.add_argument("--datasets", nargs="*", default=CPF)
    p.add_argument("--device", type=int, default=None,
                   help="forwarded to the CLIs (-1: the CPU); by default "
                        "they run on cuda:0")
    p.add_argument("--dry_run", action="store_true",
                   help="print every CLI command without running it")
    p.add_argument("--data_path", type=str, default=None,
                   help="forwarded to the CLIs")
    args = p.parse_args(argv)
    extra = {}
    if args.device is not None:
        extra["device"] = args.device
    if args.data_path is not None:
        extra["data_path"] = args.data_path
    EXPERIMENTS[args.experiment](Harness(extra, args.dry_run), args.datasets)


if __name__ == "__main__":
    main()
