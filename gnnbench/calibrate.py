"""Readings from which the limits of `correct` are set (not part of a
benchmark run).

    python3 gnnbench/calibrate.py --workload arxiv-gat-powerlaw \
        --seeds 11 12 13 --control-seeds 3 [--seconds 0]

For each seed: the cell's set-up (inputs, the port's first steps through
the window's own calls), an optional window of `--seconds`, then the
numbers of `correct` for the port against the reference (the lower
readings), and on the first `--control-seeds` seeds also for the
reference in the control's precision and for the reference with half of
each batch left out (upper readings), each in the port's place. One JSON
line per seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout first, and not this folder, whose modules (trace, data) would
# shadow top-level ones
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gnnbench: no CUDA device", file=sys.stderr)
        return 2
    from glnn_tpu_torch.cli.common import configure_numerics
    from glnn_tpu_torch.ops import cuda_build

    from gnnbench.harness import find_cell, loop_class
    from gnnbench.reference import CONTROL, EXACT

    configure_numerics()
    cuda_build.build()
    dev = torch.device("cuda:0")
    cell = find_cell(ROOT, args.workload)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        info = {}
        loop = loop_class(cell)(cell, seed, dev, ROOT, info)
        loop.setup()
        if args.seconds > 0 or loop.role == "serve":
            loop.window(max(args.seconds, 1.0))
        loop.release()
        row = {"seed": seed, "detail": {}}
        row["port"] = loop.check(detail=row["detail"])
        if k < args.control_seeds:
            row["control"] = loop.check(CONTROL)
            if loop.role != "serve":
                row["half_batch"] = loop.check(EXACT, "half_batch")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
