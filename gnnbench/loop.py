"""What every loop shares. A traffic file names its loop (`"loop"`), and
the harness finds it as `loops/<loop>.py`, whose `LOOP` is a subclass of
`Loop`: `setup()` builds the inputs from the seed and warms up,
`window(seconds)` measures and returns the cell's end-to-end metric,
`traced(seconds)` runs a short part under the profiler,
`reader_context(summary)` gives the per-layer readers their context,
`release()` frees the port's objects, and `check(prec, fault, detail)`
gives the numbers of `correct`.

`EpochLoop` drives a runner's epochs: a train epoch, then the eval and
the metrics row, whose host floats end each epoch in a synchronise. Its
set-up runs the first epochs through the same calls, with the check's
hooks on the model and the optimizer (`capture`); the window runs on the
same objects.
"""

from __future__ import annotations

import math
import time

import torch

from gnnbench.trace import ITER, profile


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def counts():
    from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda

    return {**spmm_cuda.counts, **gat_cuda.counts, **cuda_build.counts}


def conf_of(recipe: dict, ds: dict) -> dict:
    return dict(recipe, feat_dim=ds["n_feats"], label_dim=ds["n_classes"])


def program_model(conf, weights, device):
    from glnn_tpu_torch.nn.models import Model

    model = Model(conf).to(device)
    model.load_state_dict(weights, strict=True)
    return model


class Loop:
    """The cell, the seed, the device, the info lines, and the trace
    file's fixed place. `role` names the loop for the readers, `metric`
    the end-to-end metric its window gives."""

    role = ""
    metric = ""

    def __init__(self, cell: dict, seed: int, device, root, info: dict,
                 scale: dict | None = None):
        """`scale`: {"dataset" | "teacher" | "student" | "traffic": keys
        that replace the configuration's or the traffic's} (small shapes
        for the CPU tests)."""
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = {k: (dict(v, **scale[k]) if scale and k in scale else v)
                    for k, v in cell["config_data"].items()}
        self.traffic = dict(cell["traffic_data"], **(scale or {}).get(
            "traffic", {}))
        self.ds = self.cfg["dataset"]
        self.root, self.info = root, info
        self.trace_path = root / "build" / "gnnbench" / "trace.json"

    def part(self, name, t0):
        self.info.setdefault("setup_parts_s", {})[name] = \
            time.perf_counter() - t0


class EpochLoop(Loop):
    """Epochs of a runner: `train_epoch(i)` -> loss, then the eval and
    the metrics row, whose host floats end each epoch in a synchronise."""

    def epoch(self, i: int):
        t0 = time.perf_counter()
        loss = self.train_epoch(i)
        t1 = time.perf_counter()
        out = self.eval_fn()
        row = self.metrics_row(out)
        t2 = time.perf_counter()
        return loss, out, row, (t1 - t0, t2 - t1)

    def warmup(self):
        """Epochs until the check's steps are captured (at least one);
        keeps the last eval's log-probs and the state they came from."""
        t0 = time.perf_counter()
        i = 0
        while True:
            i += 1
            c0 = counts()
            loss, out, row, spans = self.epoch(i)
            if i == 1:
                self.info["first_epoch_ms"] = 1e3 * sum(spans)
                c1 = counts()
                self.info["launches_first_epoch"] = {
                    k: c1[k] - c0.get(k, 0) for k in c1 if c1[k] != c0.get(k, 0)}
            if self.capture.done:
                break
            if i > 1000:
                raise RuntimeError("the check's steps were never reached")
        self.capture.remove()
        self.eval_state = {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()}
        self.eval_out = out.detach().cpu()
        self.warm_epochs = i
        self.part("warmup", t0)

    def window(self, seconds: float) -> dict:
        spans, losses = [], []
        c0 = counts()
        t0 = time.perf_counter()
        i, elapsed = self.warm_epochs, 0.0
        while elapsed < seconds:
            i += 1
            loss, _, _, sp = self.epoch(i)
            losses.append(loss)
            spans.append(sp)
            elapsed = time.perf_counter() - t0
        c1 = counts()
        n = len(losses)
        self.info["launches_per_epoch"] = {
            k: (c1[k] - c0.get(k, 0)) / n for k in c1 if c1[k] != c0.get(k, 0)}
        self.warm_epochs = i
        self.window_epochs, self.window_s = n, elapsed
        self.spans = {"train": [s[0] for s in spans],
                      "eval": [s[1] for s in spans]}
        self.attempted = n
        self.failed = sum(1 for x in losses if not math.isfinite(x))
        return {self.metric: 1e3 * elapsed / n}

    def traced(self, min_seconds: float) -> dict:
        """Epochs under the profiler, at least one and `min_seconds`."""
        state = {"n": 0}

        def run():
            t0 = time.perf_counter()
            while state["n"] == 0 or time.perf_counter() - t0 < min_seconds:
                with torch.profiler.record_function(ITER):
                    self.epoch(self.warm_epochs + state["n"] + 1)
                state["n"] += 1

        t0 = time.perf_counter()
        summary = profile(run, self.device, self.trace_path)
        wall = time.perf_counter() - t0
        untraced = 1e3 * self.window_s / self.window_epochs
        self.info["trace"] = {"epochs": state["n"], "events": summary["events"],
                              "bytes": summary["trace_bytes"],
                              "wall_s_with_export": wall,
                              "untraced_epoch_ms": untraced}
        summary["calls"] = state["n"]
        return summary

    def reader_context(self, summary) -> dict:
        return {"loop": self.cell["traffic_data"]["loop"], "role": self.role,
                "spans": self.spans, "trace": summary,
                "ops": self.ops_per_epoch(), "calls": summary["calls"],
                "flops": self.flops_per_epoch() * self.window_epochs,
                "elapsed_s": self.window_s,
                "dtype": self.recipe.get("compute_dtype", "float32")}

    def release(self):
        """Free the port's objects; the check keeps the captured stage."""
        del self.model, self.optimizer, self.train_epoch, self.eval_fn
        self.capture = self.capture.stage
        free(self.device)


