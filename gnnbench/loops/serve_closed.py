"""`serve_closed`: one client in a closed loop. A request's feature rows
are gathered from a pinned host table before it is issued (not timed),
then copied to the device, scored by `engine.make_mlp_eval_fn(model)` and
copied back (timed). Set-up serves one request of every size the traffic
draws, so that nothing is first run inside the window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gnnbench import check, data
from gnnbench.loop import Loop, conf_of, free, program_model, sync
from gnnbench.reference import EXACT
from gnnbench.reference import train as rtrain
from gnnbench.trace import ITER, profile


class ServeClosed(Loop):
    """One client, closed loop. A request's latency runs from its issue
    (the copy in) until its log-probs are in host memory and the host has
    returned from its wait: by two CUDA events on the stream, one recorded
    before the copy in and one after the wait (the device's clock), with
    the host's clock over the same span read beside them for comparison
    (info line)."""

    role = "serve"
    metric = "infer_p95_ms"

    def setup(self):
        from glnn_tpu_torch.train import engine

        dev, ds, seed, tr = self.device, self.ds, self.seed, self.traffic
        recipe = self.cfg["student"]
        t0 = time.perf_counter()
        feats, _, _ = data.make_nodes(ds, seed, dev)
        self.table = feats.cpu()
        if dev.type == "cuda":
            self.table = self.table.pin_memory()
        del feats
        self.table_np = self.table.numpy()
        self.part("inputs", t0)
        t0 = time.perf_counter()
        conf = conf_of(recipe, ds)
        self.recipe = conf
        spec = data.weight_spec(recipe, ds["n_feats"], ds["n_classes"])
        self.weights = data.make_weights(spec, seed, dev)
        self.model = program_model(conf, self.weights, dev)
        self.model.eval()
        self.eval_fn = engine.make_mlp_eval_fn(self.model)
        hi = tr["max_nodes"]
        pin = dev.type == "cuda"
        self.x_stage = torch.empty((hi, ds["n_feats"]), pin_memory=pin)
        self.out_stage = torch.empty((hi, ds["n_classes"]), pin_memory=pin)
        self.requests = data.Requests(ds["n_nodes"], tr["min_nodes"], hi,
                                      tr["distinct_sizes"], tr["sample_every"],
                                      seed)
        self.part("model", t0)
        t0 = time.perf_counter()
        for size in sorted(set(self.requests.sizes.tolist())):
            self._serve(self._gather(np.arange(size) % ds["n_nodes"]))
        sync(dev)
        self.part("warmup", t0)

    def _gather(self, ids) -> int:
        """The request's feature rows into the pinned stage (not timed)."""
        k = ids.shape[0]
        np.take(self.table_np, ids, axis=0, out=self.x_stage.numpy()[:k])
        return k

    def _serve(self, k: int) -> np.ndarray:
        """Copy in, score, copy out, wait: the request's log-probs (a view
        of the pinned out stage)."""
        xd = self.x_stage[:k].to(self.device, non_blocking=True)
        out = self.eval_fn(xd)
        self.out_stage[:k].copy_(out, non_blocking=True)
        sync(self.device)
        return self.out_stage.numpy()[:k]

    def _run(self, seconds, keep=None):
        """Requests for `seconds`: (latencies by the device's clock and by
        the host's, in s; requests; failed; wall seconds)."""
        cuda = self.device.type == "cuda"
        marks, host, failed, n = [], [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ids, kept = self.requests.next()
            k = self._gather(ids)
            h0 = time.perf_counter()
            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            res = self._serve(k)
            if cuda:
                ev1.record()
                marks.append((ev0, ev1))
            host.append(time.perf_counter() - h0)
            n += 1
            if res.shape != (k, self.ds["n_classes"]) or not np.isfinite(res).all():
                failed += 1
            if keep is not None and kept:
                keep.append((ids, res.copy()))
        sync(self.device)
        lat = [a.elapsed_time(b) / 1e3 for a, b in marks] if cuda else host
        return lat, host, n, failed, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        self.kept = []
        lat, host, n, failed, wall = self._run(seconds, self.kept)
        self.attempted, self.failed = n, failed
        diff = np.asarray(host) - np.asarray(lat)
        self.info["requests"] = {
            "n": n, "wall_s": wall,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "max_ms": 1e3 * float(max(lat)), "kept": len(self.kept),
            "host_clock_p95_ms": 1e3 * float(np.percentile(host, 95)),
            "host_clock_p50_ms": 1e3 * float(np.percentile(host, 50)),
            "host_minus_events_ms": {
                q: 1e3 * float(np.percentile(diff, p))
                for q, p in (("p5", 5), ("p50", 50), ("p95", 95))}}
        return {self.metric: 1e3 * float(np.percentile(lat, 95))}

    def traced(self, min_seconds: float) -> dict:
        state = {}

        def run():
            with torch.profiler.record_function(ITER):
                state["n"] = self._run(min_seconds)[2]

        summary = profile(run, self.device, self.trace_path)
        self.info["trace"] = {"requests": state["n"],
                              "events": summary["events"],
                              "bytes": summary["trace_bytes"]}
        summary["calls"] = state["n"]
        return summary

    def reader_context(self, summary) -> dict:
        return {"loop": "serve_closed", "role": self.role, "spans": {},
                "trace": summary, "ops": {}, "calls": summary["calls"],
                "flops": None, "elapsed_s": None,
                "dtype": self.recipe.get("compute_dtype", "float32")}

    def release(self):
        del self.model, self.eval_fn
        free(self.device)

    def check(self, prec=None, fault=None, detail=None) -> dict:
        kept = self.kept
        numbers = {}
        if not kept:
            numbers["request_gap"] = math.inf
            return numbers
        ids = torch.from_numpy(np.concatenate([i for i, _ in kept]))
        x = self.table[ids].to(self.device)
        ref = rtrain.eval_log_probs(self.weights, self.recipe, x, EXACT)
        port = (torch.from_numpy(np.concatenate([o for _, o in kept]))
                if prec is None
                else rtrain.eval_log_probs(self.weights, self.recipe, x, prec))
        numbers["request_gap"] = check.max_gap(port, ref)
        return numbers


LOOP = ServeClosed
