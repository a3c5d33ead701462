"""Pieces of the benchmark found by name: `<folder>/<name>.py`, loaded as a
module of its own (a loop, a model's work, a per-layer metric's reader),
so that a later change adds a file and edits none."""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"gnnbench: no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gnnbench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
