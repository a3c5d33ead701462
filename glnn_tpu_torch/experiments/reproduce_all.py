"""One-command Table-3 reproduction on the port (steps 3 and 4 of
`experiments/reproduce_all.sh`): the six paper families (SAGE teacher and
GLNN student on CPF, ogbn-arxiv and ogbn-products, transductive and
inductive) over the dataset files under DATA, then the aggregator.

    python -m glnn_tpu_torch.experiments.reproduce_all [--dry_run]
        [--device N] [DATA]

--dry_run prints every command, each CLI run of every family included,
and runs none. The download steps (fetch the CPF npz files; fetch and
convert the OGB graphs with the `ogb` package) are not ported: put the
files under DATA first. Without them the first run stops at its loader's
ValueError, which names the missing file. --device is forwarded to the
CLIs (-1: the CPU); by default they run on cuda:0.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from glnn_tpu_torch.experiments import run_experiments

FAMILIES = ("sage_cpf", "glnn_cpf", "sage_arxiv", "glnn_arxiv",
            "sage_products", "glnn_products")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_path", nargs="?", default="./data")
    p.add_argument("--dry_run", action="store_true",
                   help="print every command without running it")
    p.add_argument("--device", type=int, default=None,
                   help="forwarded to the CLIs (-1: the CPU)")
    args = p.parse_args(argv)

    print("== 1-2/4 fetch CPF, fetch and convert OGB: not ported (they "
          f"download); put the dataset files under {args.data_path} ==",
          flush=True)
    print("== 3/4 paper runs (tran + ind; num_exp/max_epoch/patience of "
          "the paper's scripts) ==", flush=True)
    flags = ["--data_path", args.data_path]
    if args.device is not None:
        flags += ["--device", str(args.device)]
    if args.dry_run:
        flags.append("--dry_run")
    for exp in FAMILIES:
        run_experiments.main([exp, *flags])

    print("== 4/4 aggregate vs published Table 3 ==", flush=True)
    cmd = [sys.executable, "-m", "glnn_tpu_torch.experiments.aggregate_table3",
           "--out", "table3.txt"]
    print("+", " ".join(cmd), flush=True)
    if not args.dry_run:
        subprocess.run(cmd, check=True, env=run_experiments.child_env())
    print("done. Compare table3.txt against the paper's accuracies.")


if __name__ == "__main__":
    main()
