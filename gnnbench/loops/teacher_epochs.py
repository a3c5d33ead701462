"""`teacher_epochs`: the teacher runner's epoch, `engine._teacher_epoch_fn`
(a full-batch step of the configuration's teacher) and then the
intermediate eval `engine.make_eval_fn(model)` with the runner's metrics
row, repeated, as `eval_interval` 1 (the CLI default) runs them.

The reference follows full-batch teachers; a sampled teacher needs a loop
of its own, and this one refuses it. The model's counted work comes from
`models/<model_name>.py`.
"""

from __future__ import annotations

import functools
import logging
import time

import torch

from gnnbench import check, data, work
from gnnbench.capture import Capture
from gnnbench.loop import EpochLoop, conf_of, free, program_model, sync
from gnnbench.reference import EXACT
from gnnbench.reference import graph as rgraph
from gnnbench.reference import train as rtrain

LOG = logging.getLogger("gnnbench")


class TeacherEpochs(EpochLoop):
    role = "train"
    metric = "teacher_epoch_ms"

    def setup(self):
        from glnn_tpu_torch.graph.container import build_graph
        from glnn_tpu_torch.train import engine
        from glnn_tpu_torch.train.state import make_adam

        dev, ds, seed = self.device, self.ds, self.seed
        recipe = self.cfg["teacher"]
        self.work = work.model_work(recipe["model_name"])
        t0 = time.perf_counter()
        self.feats, self.labels, split = data.make_nodes(ds, seed, dev)
        self.idx_train, self.idx_val, self.idx_test = split
        src, dst = data.make_graph(ds, seed, dev)
        src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
        del src, dst
        self.part("inputs", t0)
        t0 = time.perf_counter()
        g = build_graph(src_h, dst_h, ds["n_nodes"])
        del src_h, dst_h
        self.part("build_graph", t0)
        t0 = time.perf_counter()
        self.g = g.to(dev)
        del g
        sync(dev)
        self.part("graph_to_device", t0)
        self.info["rows"] = rgraph.row_histogram(self.g.indptr[:-1].long())
        t0 = time.perf_counter()
        conf = conf_of(recipe, ds)
        self.recipe = conf
        spec = data.weight_spec(recipe, ds["n_feats"], ds["n_classes"])
        self.init = data.make_weights(spec, seed, dev)
        self.model = program_model(conf, self.init, dev)
        if engine._use_sampled_sage(conf, self.model):
            raise ValueError("teacher_epochs follows full-batch teachers; a "
                             "sampled teacher needs a loop of its own")
        self.optimizer = make_adam(self.model.parameters(),
                                   conf["learning_rate"], conf["weight_decay"])
        self.gen = torch.Generator(device=dev).manual_seed(
            data.sub_seed(seed, "program"))
        self.capture = Capture(self.model, self.optimizer, self.init,
                               self.traffic["check_steps"],
                               conf["weight_decay"])
        self.train_epoch = engine._teacher_epoch_fn(
            conf, self.model, self.optimizer, LOG, self.g, self.feats,
            self.labels, self.idx_train, self.gen)
        evaluate = engine.make_eval_fn(self.model)
        self.eval_fn = functools.partial(evaluate, self.g, self.feats)
        idx = (self.idx_train, self.idx_val, self.idx_test)
        self.metrics_row = lambda out: engine._metrics_row(
            (out, self.labels, i) for i in idx)
        self.part("model", t0)
        self.warmup()

    def flops_per_epoch(self) -> float:
        return self.work.epoch_flops(self.recipe, self.ds,
                                     data.n_edges(self.ds))

    def ops_per_epoch(self) -> dict:
        return self.work.epoch_ops(self.recipe, self.ds,
                                   data.n_edges(self.ds))

    def check(self, prec=None, fault=None, detail=None) -> dict:
        """The numbers of this run (`prec` and `fault` put the reference
        in the port's place: the control's and the faults' readings;
        `detail` receives each step's and leaf's gap)."""
        dev, ds = self.device, self.ds
        src, dst = data.make_graph(ds, self.seed, dev)
        ref = rgraph.build(src, dst, ds["n_nodes"])
        del src, dst
        numbers = {}
        if hasattr(self, "g"):
            numbers["graph_mismatch"] = rgraph.mismatches(self.g, ref)
            del self.g
            free(dev)
        recipe = self.recipe
        n_steps = self.traffic["check_steps"]

        def run(p, fault_=None):
            gen = torch.Generator(device=dev).manual_seed(
                data.sub_seed(self.seed, "program"))
            return rtrain.follow_full_batch(
                self.init, recipe, ref, self.feats, self.labels,
                self.idx_train, gen, n_steps, p, fault_)

        exact = run(EXACT)
        port = self.capture if prec is None else run(prec, fault)
        numbers.update(check.compare_stage(port, exact, detail))
        del exact, port
        ref_eval = rtrain.eval_log_probs(self.eval_state, recipe, self.feats,
                                         EXACT, graph=ref)
        port_eval = (self.eval_out if prec is None else
                     rtrain.eval_log_probs(self.eval_state, recipe,
                                           self.feats, prec, graph=ref))
        numbers["eval_gap"] = check.max_gap(port_eval, ref_eval)
        return numbers


LOOP = TeacherEpochs
