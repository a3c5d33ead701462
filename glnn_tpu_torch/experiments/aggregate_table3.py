"""Aggregate reproduction runs into a Table-3 comparison
(`experiments/aggregate_table3.py`, with one repair).

Walks ``outputs/`` for the append-only ``exp_results`` files the CLIs
write (one level above each seed dir; mean then std columns), takes each
file's LAST row (the most recent aggregate), and prints per-(setting,
dataset, model) accuracies next to the published targets. The "prod" row
interpolates tran/ind with the paper's production weighting (0.8 * tran +
0.2 * ind at the default --split_rate 0.2).

The repair: a run's setting is the layout's own first component
(``inductive/...`` is ind, anything else tran). The JAX aggregator takes
any path component that starts with ``ind`` as inductive, so a
transductive run whose dataset or model directory starts with ``ind``
lands in its inductive rows.

    python -m glnn_tpu_torch.experiments.aggregate_table3 [--outputs DIR]
        [--out table3.txt] [--split_rate 0.2]

Run after any subset of runs: rows without data print as "--".
"""

from __future__ import annotations

import argparse
from pathlib import Path

# the paper's production accuracies and, where published, the
# per-setting ones
TARGETS_PROD = {
    ("cora", "SAGE"): 79.29, ("cora", "GLNN"): 78.28,
    ("citeseer", "SAGE"): 68.38, ("citeseer", "GLNN"): 69.27,
    ("pubmed", "SAGE"): 74.88, ("pubmed", "GLNN"): 74.71,
    ("a-computer", "SAGE"): 82.14, ("a-computer", "GLNN"): 82.29,
    ("a-photo", "SAGE"): 91.08, ("a-photo", "GLNN"): 92.38,
    ("ogbn-arxiv", "SAGE"): 70.73, ("ogbn-arxiv", "GLNN"): 65.09,
    ("ogbn-products", "SAGE"): 76.60, ("ogbn-products", "GLNN"): 75.77,
}
TARGETS_SPLIT = {  # (dataset, model, setting) -> published mean
    ("ogbn-products", "SAGE", "tran"): 76.53,
    ("ogbn-products", "SAGE", "ind"): 76.89,
    ("ogbn-products", "GLNN", "tran"): 75.92,
    ("ogbn-products", "GLNN", "ind"): 75.16,
    ("ogbn-arxiv", "GLNN", "tran"): 71.46,
    ("ogbn-arxiv", "GLNN", "ind"): 60.48,
}
DATASETS = ["cora", "citeseer", "pubmed", "a-computer", "a-photo",
            "ogbn-arxiv", "ogbn-products"]


def _last_row(path: Path):
    rows = [ln for ln in path.read_text().splitlines() if ln.strip()]
    if not rows:
        return None
    vals = [float(v) for v in rows[-1].split()]
    k = len(vals) // 2
    return vals[:k], vals[k:]          # means, stds


def collect(outputs: Path):
    """{(setting, dataset, model): (means, stds)}. model is 'SAGE' for
    the teacher dir, 'GLNN' for the SAGE_MLP* student dir."""
    got = {}
    for f in sorted(outputs.glob("**/exp_results")):
        rel = f.relative_to(outputs).parts    # setting[/split]/ds/model
        # ablation reroutes (noisy_features/noise_a/..., aug_features/)
        # nest the setting one level deeper — keyed off rel[0] they
        # would misclassify as 'tran' and shadow the main-table rows
        if rel[0] in ("noisy_features", "aug_features"):
            continue
        setting = "ind" if rel[0] == "inductive" else "tran"
        ds, model_dir = rel[-3], rel[-2]
        model = "GLNN" if "_MLP" in model_dir else model_dir
        row = _last_row(f)
        if row:
            got[(setting, ds, model)] = row
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outputs", type=Path, default=Path("outputs"))
    ap.add_argument("--out", type=Path, default=Path("table3.txt"))
    ap.add_argument("--split_rate", type=float, default=0.2)
    args = ap.parse_args(argv)

    got = collect(args.outputs) if args.outputs.exists() else {}
    lines = [f"{'dataset':>14} {'model':>6} {'setting':>7} "
             f"{'ours':>12} {'published':>9}"]
    for ds in DATASETS:
        for model in ("SAGE", "GLNN"):
            acc = {}
            for setting in ("tran", "ind"):
                row = got.get((setting, ds, model))
                if row:
                    # tran: [test]; ind: [test_tran, test_ind]
                    means, stds = row
                    val = means[-1] * 100
                    acc[setting] = (val, stds[-1] * 100)
                    tgt = TARGETS_SPLIT.get((ds, model, setting))
                    lines.append(
                        f"{ds:>14} {model:>6} {setting:>7} "
                        f"{val:7.2f}±{acc[setting][1]:4.2f} "
                        f"{tgt if tgt is not None else '--':>9}")
                else:
                    lines.append(f"{ds:>14} {model:>6} {setting:>7} "
                                 f"{'--':>12} "
                                 f"{TARGETS_SPLIT.get((ds, model, setting), '--'):>9}")
            tgt = TARGETS_PROD.get((ds, model))
            if "tran" in acc and "ind" in acc:
                prod = ((1 - args.split_rate) * acc["tran"][0]
                        + args.split_rate * acc["ind"][0])
                lines.append(f"{ds:>14} {model:>6} {'prod':>7} "
                             f"{prod:12.2f} {tgt:>9}")
            else:
                lines.append(f"{ds:>14} {model:>6} {'prod':>7} "
                             f"{'--':>12} {tgt:>9}")
    text = "\n".join(lines) + "\n"
    args.out.write_text(text)
    print(text, end="")


if __name__ == "__main__":
    main()
