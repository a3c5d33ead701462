"""Tiny shapes of each cell for the CPU tests, and a run of a cell at
them with the kernel tiers' plain versions standing in for the kernels
(a CUDA kernel has no CPU mode), as the card's path takes the kernels."""

from __future__ import annotations

import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SCALES = {
    "arxiv-gat-powerlaw": {
        "dataset": {"n_nodes": 2000, "split": [900, 300, 800],
                    "degree_law": {"kind": "power_law",
                                   "directed_edges": 14000,
                                   "exponent": 3.0}}},
    "products-mlp-serve": {"dataset": {"n_nodes": 3000,
                                       "split": [300, 200, 2500]},
                           "traffic": {"max_nodes": 256, "distinct_sizes": 16,
                                       "sample_every": 4}},
}
CELLS = tuple(SCALES)


def kernel_tier(monkeypatch):
    from glnn_tpu_torch import ops

    monkeypatch.setattr(ops, "_tier_selected", lambda device: True)


def run(cell: str, seed: int = 2 ** 31 + 12345, traced: bool = False,
        seconds: float = 0.3) -> dict:
    from gnnbench.harness import run_cell

    return run_cell(ROOT, cell, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter(), scale=SCALES[cell],
                    emit=lambda line: None)


def loop(cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.3):
    """The cell's loop at its tiny shapes, set up, run and released, ready
    for `check`."""
    from gnnbench.harness import find_cell, loop_class

    c = find_cell(ROOT, cell)
    lp = loop_class(c)(c, seed, torch.device("cpu"), ROOT, {}, SCALES[cell])
    lp.setup()
    lp.window(seconds)
    lp.release()
    return lp
