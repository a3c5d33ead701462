"""The benchmark of `glnn_tpu_torch`: one run of one cell.

    python3 gnnbench/run.py --workload arxiv-gat-powerlaw --seed 7 \
        --seconds 20 --trace 0

Prints info lines, then as its last line one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device` (and with `--trace 1`
`breakdown`), and `checks` last: each number compared with its limit,
which also close standard error. Exits non-zero, printing no result, when
no CUDA device is present, and when a module of JAX or of the JAX package
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout first, and not this folder, whose modules (trace, data) would
# shadow top-level ones
sys.path[0] = str(ROOT)


def caches(root: Path) -> None:
    """Kernel caches at fixed places inside the checkout."""
    base = root / "build" / "gnnbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    caches(ROOT)
    import torch

    from gnnbench.harness import find_cell, forbidden_modules, run_cell

    chips = find_cell(ROOT, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gnnbench: {args.workload} needs {chips} CUDA device(s); the "
              f"benchmark runs only on the card", file=sys.stderr)
        return 2

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda:0"), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gnnbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
