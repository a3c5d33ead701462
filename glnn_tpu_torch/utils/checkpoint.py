"""Model checkpoints (`glnn_tpu/utils/checkpoint.py`).

The JAX package writes {params, batch_stats} as an orbax directory
`model.ckpt/`; the port writes the model's `state_dict` (parameters and
batch-norm statistics) with `torch.save` to the file `model.ckpt`. The
out.npz soft-label artifact is written by the CLIs and keeps its format.
"""

from __future__ import annotations

import torch


def save_model(path, state_dict: dict) -> None:
    """Write `state_dict` to `path`, every tensor on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_model(path) -> dict:
    """The state dict saved by `save_model`, on the CPU (for
    `Model.load_state_dict`)."""
    return torch.load(path, map_location="cpu", weights_only=True)
