"""One run of one cell: find its pieces by name, set up, measure, trace,
check, and assemble the result line.

Everything a cell is made of is found by the names in `BENCHMARK.json`:
the configuration's file (`configs/<config>.json`), the traffic's
(`traffic/<traffic>.json`), the loop that the traffic names
(`loops/<loop>.py`), the work of the configuration's model
(`models/<model_name>.py`, `work.model_work`), the cell's limits
(`limits/<cell>.json`) and one reader per per-layer metric
(`metrics/<metric>.py`, a `read(ctx)` that returns a number or None).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from gnnbench import check, find

HERE = find.HERE
FORBIDDEN = ("jax", "jaxlib", "flax", "glnn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> dict:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_data"] = load_json(root / configs[cell["config"]]["file"])
    cell["traffic_data"] = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = HERE / "limits" / f"{name}.json"
    cell["limits"] = load_json(limits)["limits"] if limits.exists() else {}
    metric = loop_class(cell).metric
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if m["name"] in ("setup_s", metric)
                          and name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if name in m.get("workloads", [name])]
    return cell


def loop_class(cell: dict):
    """The `Loop` subclass of `loops/<loop>.py` that the traffic names."""
    return find.module("loops", cell["traffic_data"]["loop"]).LOOP


def reader(metric: str):
    return find.module("metrics", metric).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: `glnn_tpu_torch` is not `glnn_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    """The platform, the card's name, the cards the run uses (the cell's
    `chips`, each checked present before the run) and the peak of the
    fullest."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                     for i in range(chips))}


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, scale=None, emit=print) -> dict:
    """The result of one run; `emit` takes the info lines. `scale`
    overrides dataset sizes (the CPU tests' tiny shapes)."""
    cell = find_cell(root, name)
    info = {"workload": name, "seed": seed}
    from glnn_tpu_torch.cli.common import configure_numerics
    from glnn_tpu_torch.ops import cuda_build

    configure_numerics()
    if device.type == "cuda":
        t0 = time.perf_counter()
        built = cuda_build.build()
        info.setdefault("setup_parts_s", {})["kernels"] = \
            time.perf_counter() - t0
        info["kernels_built"] = sorted(built)
    loop = loop_class(cell)(cell, seed, device, root, info, scale)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    metrics = loop.window(seconds)
    result_metrics = {}
    summary = None
    if traced:
        summary = loop.traced(cell["traffic_data"]["trace_seconds"])
        ctx = loop.reader_context(summary)
        for m in cell["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            if m["name"] in metrics:
                result_metrics[m["name"]] = {"value": metrics[m["name"]],
                                             "unit": m["unit"]}
        info["setup_s"] = setup_s
    dev = device_info(device, cell["chips"])
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit()
    loop.release()
    t0 = time.perf_counter()
    numbers = loop.check()
    info["check_s"] = time.perf_counter() - t0
    info["numbers"] = numbers
    emit(json.dumps({"info": info}))
    correct, table = check.judge(numbers, cell["limits"])
    result = {"correct": correct, "attempted": loop.attempted,
              "failed": loop.failed, "metrics": result_metrics, "device": dev}
    if summary is not None and summary.get("breakdown"):
        result["breakdown"] = summary["breakdown"]
    result["checks"] = table
    return result


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
