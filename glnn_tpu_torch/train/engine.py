"""Train/eval functions and the four runners (`glnn_tpu/train/engine.py`).

* `make_gnn_train_step`: the full-batch GNN step (GCN, GAT, APPNP, and SAGE
  with --sage_sampling full): NLL on idx_train, Adam step; the runner's
  generator draws every dropout mask, APPNP's per-hop edge drop included.
* `make_eval_fn`: all-node log-probs in eval mode. Intermediate evals are
  marked `ops.inference_mode()`, so on CUDA the auto backend takes the int8
  SpMM tier; `exact=True` (the final eval, whose log-probs become out.npz
  and the student's KL targets) leaves the mark off.
* `make_mlp_epoch_fn`: shuffled fixed-size minibatches with the tail
  remainder dropped, max(1, n // batch_size) batches.
* `make_mlp_eval_fn`: chunked eval, no tail dropping. On CUDA each chunk
  replays a CUDA graph of the eval forward captured for its row bucket
  (`row_bucket`); on the CPU, or inside another capture, it runs eagerly.
  `eval_graph_counts()` gives the captures, replays and eager calls.
* Runners: eval every `eval_interval` epochs, best snapshot on
  score_val >= best (ties refresh it), early stop when count == patience,
  restore the best before the final eval; `state_out`, when given, receives
  the restored best `state_dict` and `best_epoch` (for --save_results).
  Distillation runs two optimizer passes per epoch (hard labels scaled by
  lamb, then teacher log-probs scaled by 1 - lamb); Adam advances on the
  zero-scaled pass too.
* Inductive runners: train on the observed subgraph only (obs-local
  indices `obs_idx_*` are positions within `idx_obs`; obs node i is global
  node idx_obs[i]). A GNN evaluates twice per eval, on `obs_g` with the obs
  features and on the full `g`; an MLP once on all features, its obs rows
  taken by `idx_obs`. The returned all-node log-probs merge the two:
  `out = out_all; out[idx_obs] = obs_out`. Rows of `loss_and_score` have 9
  fields (7 transductive).
* Placement: the runners are written once. What a rank of a sharded run
  does otherwise (its row blocks and halo shards, its generators, batch
  norm over the ranks, the data-parallel and halo epochs and evals) comes
  from the placement it passes (`place`); `LocalPlacement` is the one
  process's. This module imports nothing of the sharded package.
* Spans (recorded only under a profiler, utils/profiling.py): the
  full-batch teacher epoch `runner.train_epoch` around `runner.forward`,
  `runner.backward` and `runner.optimizer`; `runner.eval`;
  `runner.metrics_row`; `runner.eval_graph` around each replay of the MLP
  eval's graph, inside `runner.eval`; and `runner.host_read` around every
  device-to-host read of a runner's loss or metrics (`host_float`).
"""

from __future__ import annotations

import bisect
import collections
import math

import numpy as np
import torch

from glnn_tpu_torch import ops
from glnn_tpu_torch.train.losses import (
    accuracy,
    kl_div_batchmean_log_target,
    log_softmax,
    nll_loss,
)
from glnn_tpu_torch.train.sage_sampled import make_sage_sampled_epoch_fn
from glnn_tpu_torch.train.state import restore, snapshot
from glnn_tpu_torch.utils.profiling import StepTimer, span

_TRAIN_EPOCH = span("runner.train_epoch")
_FORWARD = span("runner.forward")
_BACKWARD = span("runner.backward")
_OPTIMIZER = span("runner.optimizer")
_EVAL = span("runner.eval")
_EVAL_GRAPH = span("runner.eval_graph")
_METRICS_ROW = span("runner.metrics_row")
_HOST_READ = span("runner.host_read")


def host_float(x: torch.Tensor) -> float:
    """A device scalar read on the host: the host waits for the device."""
    with _HOST_READ:
        return float(x)


def make_gnn_train_step(model, optimizer):
    """step(g, feats, labels, idx_train, gen) -> loss (a device scalar):
    a training-mode forward over the whole graph with its dropout masks
    drawn from `gen`, NLL on idx_train, one optimizer step."""

    def step(g, feats, labels, idx_train, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with _FORWARD:
            out = log_softmax(model(g, feats, gen)[1])
            loss = nll_loss(out[idx_train], labels[idx_train])
        with _BACKWARD:
            loss.backward()
        with _OPTIMIZER:
            optimizer.step()
        return loss.detach()

    return step


def make_eval_fn(model, exact: bool = False):
    """evaluate(g, feats) -> all-node log-probs (eval mode, no grad)."""

    @torch.no_grad()
    def evaluate(g, feats):
        with _EVAL:
            model.eval()
            if exact:
                h = model(g, feats)[1]
            else:
                with ops.inference_mode():
                    h = model(g, feats)[1]
            return log_softmax(h)

    return evaluate


def make_mlp_epoch_fn(model, optimizer, batch_size: int, criterion: str,
                      lamb: float = 1.0):
    """epoch(feats, targets, gen) -> mean unscaled loss. criterion "nll"
    (int targets) or "kl" (teacher log-prob targets)."""
    use_kl = criterion == "kl"

    def epoch(feats, targets, gen):
        model.train()
        n = feats.shape[0]
        num_batches = max(1, n // batch_size)
        eff_batch = batch_size if n >= batch_size else n
        idx = torch.randperm(n, generator=gen, device=feats.device)
        losses = []
        for batch_idx in idx[: num_batches * eff_batch].view(num_batches,
                                                              eff_batch):
            optimizer.zero_grad(set_to_none=True)
            out = log_softmax(model(None, feats[batch_idx], gen)[1])
            y = targets[batch_idx]
            loss = (kl_div_batchmean_log_target(out, y) if use_kl
                    else nll_loss(out, y))
            (loss * lamb).backward()
            optimizer.step()
            losses.append(loss.detach())
        return host_float(torch.stack(losses).mean())

    return epoch


# The MLP eval's CUDA graphs. A chunk of n rows replays the graph of its
# bucket, the least size >= n on a grid of four steps an octave from 16 rows
# (ceil(16 * 2**(j/4))), so a bucket pads at most 19% past 16 rows and
# 10-4,096-row requests need 33 graphs. Chunks are cut at GRAPH_ROWS: the
# largest bucket's working set (the 3 x 256 student: a 26 MB input, 67 MB
# per hidden activation; 315 MiB for its capture and replay on an H100)
# stays small beside the card, while a chunk that large already keeps the
# device busy far longer than the replay's launch takes.
GRAPH_ROWS = 1 << 16
_BUCKETS = tuple(sorted({math.ceil(16 * 2 ** (j / 4)) for j in range(49)}))
_graph_counts = collections.Counter(captures=0, replays=0, eager=0)


def row_bucket(n: int) -> int:
    """The captured row count that serves a chunk of 1 <= n <= GRAPH_ROWS
    rows."""
    return _BUCKETS[bisect.bisect_left(_BUCKETS, n)]


def eval_graph_counts() -> dict:
    """{"captures", "replays", "eager"}: the MLP eval graphs captured and
    replayed in this process, and the eval calls that ran eagerly."""
    return dict(_graph_counts)


def _module_state(model) -> tuple[tuple, bool]:
    """(the data pointers of every parameter and buffer of `model`, whether
    any of its modules is in training mode): one walk of the module tree,
    cheaper than `parameters()`, `buffers()` and `eval()`."""
    ptrs, training, stack = [], False, [model]
    while stack:
        mod = stack.pop()
        training = training or mod.training
        for t in mod._parameters.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        for t in mod._buffers.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        stack += mod._modules.values()
    return tuple(ptrs), training


class _EvalGraphs:
    """One eval function's graphs: per bucket (graph, static input, static
    output) in `graphs`, and per chunk size the graph with the views of
    its rows in `rows`, all in one memory pool, valid while `key` holds.
    The key is what the captured work depends on and the code can see: the
    input's dtype, width and device, the model's compute dtype, the
    addresses of its parameters and buffers (in-place updates keep them, so
    replays see Adam's steps, new running statistics and
    `load_state_dict`), and the matmul precision flags. A new key drops
    every graph.

    The pool is shared because the calls run one at a time on the caller's
    stream and each copies its rows out of the static output before it
    returns: no static output is read after another graph's replay."""

    def __init__(self, model):
        self.model = model
        self.key = None
        self.graphs: dict = {}
        self.rows: dict = {}
        self.pool = None
        self.stream = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return log_softmax(self.model(None, x)[1])

    def _capture(self, bucket: int, like: torch.Tensor):
        """A warm-up run on a side stream, then the capture on it."""
        dev = like.device
        static_in = like.new_zeros((bucket,) + like.shape[1:])
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.forward(static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=self.pool,
                                                      stream=side):
            static_out = self.forward(static_in)
        _graph_counts["captures"] += 1
        self.graphs[bucket] = entry = (graph, static_in, static_out)
        return entry

    def _replay(self, chunk: torch.Tensor) -> torch.Tensor:
        """The chunk into the first rows of its bucket's static input, the
        graph replayed: the chunk's rows of the static output (a view)."""
        rows = chunk.shape[0]
        entry = self.rows.get(rows)
        if entry is None:
            bucket = row_bucket(rows)
            graph, static_in, static_out = (self.graphs.get(bucket)
                                            or self._capture(bucket, chunk))
            self.rows[rows] = entry = (graph, static_in[:rows],
                                       static_out[:rows])
        graph, rows_in, rows_out = entry
        rows_in.copy_(chunk)
        with _EVAL_GRAPH:
            graph.replay()
        _graph_counts["replays"] += 1
        return rows_out

    def __call__(self, x: torch.Tensor, step: int) -> torch.Tensor:
        model = self.model
        pointers, training = _module_state(model)
        if training:
            model.eval()
        flags = torch.backends.cuda.matmul
        key = (x.dtype, x.shape[1:], x.device,
               getattr(getattr(model, "module", model), "dtype", None),
               pointers, flags.allow_tf32,
               flags.allow_bf16_reduced_precision_reduction,
               torch.backends.cudnn.allow_tf32)
        if key != self.key:
            self.graphs.clear()
            self.rows.clear()
            self.key, self.pool = key, torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(x.device)
        n = x.shape[0]
        if n <= step:
            return self._replay(x).clone()
        out = None
        for i in range(0, n, step):
            piece = self._replay(x[i:i + step])
            if out is None:
                out = piece.new_empty((n,) + piece.shape[1:])
            out[i:i + piece.shape[0]].copy_(piece)
        return out


def make_mlp_eval_fn(model, batch_size: int | None = None):
    """evaluate(feats) -> all-node log-probs, in chunks of `batch_size` rows
    (eval mode is row-independent, so chunks equal the full forward).

    On CUDA each chunk (at most GRAPH_ROWS rows) is copied into the first
    rows of its bucket's static input and that bucket's graph of the
    forward is replayed (captured on first use); the padding rows are
    computed and never read. The model is put in eval mode where a module
    is in training mode. On the CPU, or while a capture is underway, the
    forward runs eagerly. Calls must not overlap: they share the static
    buffers. `evaluate.graphs` holds the graphs."""

    graphs = _EvalGraphs(model)

    @torch.no_grad()
    def evaluate(feats):
        with _EVAL:
            n = feats.shape[0]
            step = n if batch_size is None else batch_size
            if (feats.device.type != "cuda" or n == 0
                    or torch.cuda.is_current_stream_capturing()):
                model.eval()
                _graph_counts["eager"] += 1
                return torch.cat([graphs.forward(feats[i:i + step])
                                  for i in range(0, n, step)])
            return graphs(feats, min(step, GRAPH_ROWS))

    evaluate.graphs = graphs
    return evaluate


def _fanouts(conf):
    fan = conf.get("fan_out", "5,5")
    if isinstance(fan, str):
        fan = [int(x) for x in fan.split(",")]
    fan = [int(x) for x in fan]
    if len(fan) != conf["num_layers"]:
        raise ValueError(
            f"fan_out length {len(fan)} != num_layers {conf['num_layers']}")
    return fan


class _BestTracker:
    """score_val >= best refreshes the snapshot and resets patience."""

    def __init__(self, model):
        self.best_epoch = 0
        self.best_score_val = 0.0
        self.count = 0
        self.snap = snapshot(model)

    def update(self, epoch: int, score_val: float, model) -> None:
        if score_val >= self.best_score_val:
            self.best_epoch = epoch
            self.best_score_val = score_val
            self.snap = snapshot(model)
            self.count = 0
        else:
            self.count += 1


def _subset_metrics(out, labels, idx):
    """(loss, score) of log-probs `out` restricted to idx (host floats)."""
    sub, lab = out[idx], labels[idx]
    return host_float(nll_loss(sub, lab)), host_float(accuracy(sub, lab))


def _debug_guard(conf, loss: float, epoch: int, where: str) -> None:
    """Opt-in (--debug_checks) per-epoch finite-loss guard."""
    if conf.get("debug_checks") and not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss {loss} at epoch {epoch} in {where}")


def _tensors(device, *arrays):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


def _use_sampled_sage(conf, model) -> bool:
    """SAGE teachers train on fanout-sampled minibatches unless
    conf["sage_sampling"] is "full"; every other GNN trains full-batch."""
    return ("SAGE" in model.model_name and not model.is_mlp
            and conf.get("sage_sampling", "auto") != "full")


def _metrics_row(evals):
    """[loss_1, ..., loss_k, score_1, ..., score_k] of (out, labels, idx)
    triples."""
    with _METRICS_ROW:
        pairs = [_subset_metrics(*e) for e in evals]
    return [p[0] for p in pairs] + [p[1] for p in pairs]


def _fit(conf, model, logger, loss_and_score, train_epoch, eval_row,
         score_names, where, state_out):
    """The epoch loop every runner shares: `train_epoch(epoch)` -> loss (a
    host float), and every eval_interval epochs `eval_row()` -> the metrics
    row (losses, then scores named `score_names`, score_val second). Stops at
    patience or max_epoch, restores the best snapshot into `model` and fills
    `state_out`; returns the best epoch."""
    tracker = _BestTracker(model)
    timer = StepTimer()
    k = len(score_names)
    for epoch in range(1, conf["max_epoch"] + 1):
        with timer:
            loss = train_epoch(epoch)
        _debug_guard(conf, loss, epoch, where)
        if epoch % conf["eval_interval"] == 0:
            row = eval_row()
            logger.debug(f"Ep {epoch:3d} | loss: {loss:.4f} | " + " | ".join(
                f"{name}: {v:.4f}" for name, v in zip(score_names, row[k:])))
            loss_and_score.append([epoch, *row])
            tracker.update(epoch, row[k + 1], model)

        if tracker.count == conf["patience"] or epoch == conf["max_epoch"]:
            break

    logger.info(
        f"mean epoch time: {timer.mean * 1e3:.1f} ms over {timer.count} epochs")
    restore(model, tracker.snap)
    if state_out is not None:
        state_out["state_dict"] = tracker.snap
        state_out["best_epoch"] = tracker.best_epoch
    return tracker.best_epoch


def _log_final(logger, best_epoch, **scores):
    logger.info(f"Best valid model at epoch: {best_epoch: 3d}, " + ", ".join(
        f"{name}: {v:.4f}" for name, v in scores.items()))


def _teacher_epoch_fn(conf, model, optimizer, logger, g, feats, labels,
                      idx_train, gen):
    """epoch(epoch) -> loss for an MLP, a sampled-SAGE or a full-batch GNN
    teacher training on (g, feats, labels, idx_train)."""
    if model.is_mlp:
        epoch_fn = make_mlp_epoch_fn(model, optimizer, conf["batch_size"],
                                     "nll")
        feats_train, labels_train = feats[idx_train], labels[idx_train]
        return lambda epoch: epoch_fn(feats_train, labels_train, gen)
    if _use_sampled_sage(conf, model):
        epoch_fn = make_sage_sampled_epoch_fn(
            model, optimizer, conf["batch_size"], _fanouts(conf),
            sampler_tier=conf.get("sampler_tier", "floyd") or "floyd")

        def sampled(epoch):
            loss, overflow = epoch_fn(g, feats, labels, idx_train, gen)
            if overflow:
                logger.warning(f"Ep {epoch}: sampler frontier cap overflow")
            return loss
        return sampled
    step_fn = make_gnn_train_step(model, optimizer)

    def full_batch(epoch):
        with _TRAIN_EPOCH:
            # sync before the timer reads, as the JAX runner does
            return host_float(step_fn(g, feats, labels, idx_train, gen))
    return full_batch


class LocalPlacement:
    """Where a runner's work goes in one process: every row, and the whole
    graph, on the runner's device. A rank of a sharded run passes the
    runners its own placement with the same methods
    (`distributed.runners.RankPlacement`): row blocks and halo shards, the
    ranks' generators, batch norm taken over the ranks, and the
    data-parallel and halo epochs and evals."""

    def generators(self, conf, device):
        """(shared, own): the run's one seeded generator, twice."""
        gen = torch.Generator(device=device).manual_seed(int(conf["seed"]))
        return gen, gen

    def observed_rows(self, x, idx_obs):
        """A GNN teacher's observed feature rows: x's rows idx_obs."""
        return x[idx_obs]

    def teacher_epoch(self, conf, model, optimizer, logger, g, x, labels,
                      idx_train, gens):
        return _teacher_epoch_fn(conf, model, optimizer, logger, g, x, labels,
                                 idx_train, gens[0])

    def distill_epoch(self, conf, model, optimizer, x, t, labels, ids_l,
                      ids_t, gens):
        """The two passes over the rows ids_l (hard labels) and ids_t (the
        teacher's log-probs t)."""
        return _distill_epoch_fn(conf, model, optimizer, x[ids_l],
                                 labels[ids_l], x[ids_t], t[ids_t], gens[0])

    def evaluators(self, conf, model, n):
        """(eval, final eval), each evaluate(g, x) -> all-node log-probs
        [n]. The final log-probs become out.npz, the student's KL targets:
        a GNN's final eval is always the exact tier."""
        if model.is_mlp:
            mlp_eval = make_mlp_eval_fn(
                model, conf.get("eval_batch_size", conf["batch_size"]))

            def evaluate(g, x):
                return mlp_eval(x)
            return evaluate, evaluate
        return make_eval_fn(model), make_eval_fn(model, exact=True)


LOCAL = LocalPlacement()


def _tran_tail(conf, model, logger, loss_and_score, state_out, train_epoch,
               evaluate, labels, idxs, names, where):
    """A transductive run from its epoch on: `_fit` with evals scoring the
    rows idxs = (fitted, val, test) under `names`, then the final eval.
    evaluate(exact) -> all-node log-probs. Returns (out, score_val,
    score_test), `out` the best checkpoint's log-probs (numpy)."""

    def eval_row():
        out = evaluate(False)
        return _metrics_row((out, labels, idx) for idx in idxs)

    best = _fit(conf, model, logger, loss_and_score, train_epoch, eval_row,
                names, where, state_out)
    out = evaluate(True)
    _, score_val = _subset_metrics(out, labels, idxs[1])
    _, score_test = _subset_metrics(out, labels, idxs[2])
    _log_final(logger, best, score_val=score_val, score_test=score_test)
    return out.cpu().numpy(), score_val, score_test


def _ind_tail(conf, model, logger, loss_and_score, state_out, train_epoch,
              evaluate, labels, idx_obs, idxs, names, where):
    """An inductive run from its epoch on: idxs = (fitted, val, test) as
    obs-local positions, then idx_test_ind (global ids); evaluate(exact)
    -> (obs_out, out_all). Returns (out, score_val, score_test_tran,
    score_test_ind), `out` the merged log-probs (numpy)."""
    obs_labels = labels[idx_obs]

    def eval_row():
        obs_out, out_all = evaluate(False)
        return _metrics_row([(obs_out, obs_labels, idx) for idx in idxs[:3]]
                            + [(out_all, labels, idxs[3])])

    best = _fit(conf, model, logger, loss_and_score, train_epoch, eval_row,
                names, where, state_out)
    obs_out, out_all = evaluate(True)
    _, score_val = _subset_metrics(obs_out, obs_labels, idxs[1])
    _, score_test_tran = _subset_metrics(obs_out, obs_labels, idxs[2])
    _, score_test_ind = _subset_metrics(out_all, labels, idxs[3])
    _log_final(logger, best, score_val=score_val,
               score_test_tran=score_test_tran, score_test_ind=score_test_ind)
    out = out_all.clone()
    out[idx_obs] = obs_out
    return out.cpu().numpy(), score_val, score_test_tran, score_test_ind


def _one_pass(evaluators, x, idx_obs):
    """An MLP's evaluate(exact) -> (obs_out, out_all): one pass over all
    the features, its obs rows taken by idx_obs."""

    def evaluate(exact):
        out_all = evaluators[exact](None, x)
        return out_all[idx_obs], out_all
    return evaluate


def run_transductive(conf, model, g, feats, labels, indices, optimizer,
                     logger, loss_and_score, device, state_out=None,
                     place=LOCAL):
    """Teacher training, transductive: an MLP, a sampled-SAGE or a
    full-batch GNN (GCN, GAT, APPNP, full SAGE) teacher on `device`. Returns
    (out, score_val, score_test) with `out` the all-node log-probs (numpy)
    from the best checkpoint. Under a rank's placement g is the rank's halo
    shard and feats its row block."""
    x, labels = _tensors(device, np.asarray(feats, np.float32), labels)
    idx_train, idx_val, idx_test = _tensors(device, *indices)
    train_epoch = place.teacher_epoch(conf, model, optimizer, logger, g, x,
                                      labels, idx_train,
                                      place.generators(conf, device))
    evaluators = place.evaluators(conf, model, labels.shape[0])
    return _tran_tail(conf, model, logger, loss_and_score, state_out,
                      train_epoch, lambda exact: evaluators[exact](g, x),
                      labels, (idx_train, idx_val, idx_test),
                      ("s_train", "s_val", "s_test"), "teacher tran runner")


def run_inductive(conf, model, g, obs_g, feats, labels, indices, optimizer,
                  logger, loss_and_score, device, state_out=None,
                  place=LOCAL):
    """Teacher training, inductive: trains on the observed subgraph `obs_g`
    (node i is global node idx_obs[i]) and evaluates on it and on the full
    `g`; an MLP trains on the observed train rows of all the features.
    `indices` = (obs_idx_train, obs_idx_val, obs_idx_test, idx_obs,
    idx_test_ind), as `graph_split` gives them. Returns (out, score_val,
    score_test_tran, score_test_ind) with `out` the merged all-node
    log-probs (numpy). Under a rank's placement g and obs_g are the rank's
    halo shards and feats its row block."""
    x, labels = _tensors(device, np.asarray(feats, np.float32), labels)
    (obs_idx_train, obs_idx_val, obs_idx_test, idx_obs,
     idx_test_ind) = _tensors(device, *indices)
    gens = place.generators(conf, device)
    evaluators = place.evaluators(conf, model, labels.shape[0])
    if model.is_mlp:
        train_epoch = place.teacher_epoch(conf, model, optimizer, logger,
                                          None, x, labels,
                                          idx_obs[obs_idx_train], gens)
        evaluate = _one_pass(evaluators, x, idx_obs)
    else:
        obs_x = place.observed_rows(x, idx_obs)
        train_epoch = place.teacher_epoch(conf, model, optimizer, logger,
                                          obs_g, obs_x, labels[idx_obs],
                                          obs_idx_train, gens)

        def evaluate(exact):
            """(obs_out, out_all): an obs graph and a full graph pass."""
            fn = evaluators[exact]
            return fn(obs_g, obs_x), fn(g, x)
    return _ind_tail(conf, model, logger, loss_and_score, state_out,
                     train_epoch, evaluate, labels, idx_obs,
                     (obs_idx_train, obs_idx_val, obs_idx_test, idx_test_ind),
                     ("s_train", "s_val", "s_tt", "s_ti"),
                     "teacher ind runner")


def _distill_epoch_fn(conf, model, optimizer, feats_l, labels_l, feats_t,
                      out_t, gen):
    """epoch(epoch) -> loss_l + loss_t: the hard-label pass scaled by lamb,
    then the teacher log-prob pass scaled by 1 - lamb."""
    lamb, batch_size = conf["lamb"], conf["batch_size"]
    hard_epoch = make_mlp_epoch_fn(model, optimizer, batch_size, "nll",
                                   lamb=lamb)
    soft_epoch = make_mlp_epoch_fn(model, optimizer, batch_size, "kl",
                                   lamb=1.0 - lamb)
    return lambda epoch: (hard_epoch(feats_l, labels_l, gen)
                          + soft_epoch(feats_t, out_t, gen))


def distill_run_transductive(conf, model, feats, labels, out_t_all,
                             distill_indices, optimizer, logger,
                             loss_and_score, device, state_out=None,
                             place=LOCAL):
    """GLNN distillation, transductive: per epoch a hard-label pass on idx_l
    scaled by lamb, then a teacher log-prob pass on idx_t scaled by
    1 - lamb. Returns (out, score_val, score_test); the logged loss_l is
    the eval-mode NLL on the hard-label set. Under a rank's placement
    feats and out_t_all are the rank's row blocks."""
    x, labels, t = _tensors(device, np.asarray(feats, np.float32), labels,
                            np.asarray(out_t_all, np.float32))
    idx_l, idx_t, idx_val, idx_test = _tensors(device, *distill_indices)
    train_epoch = place.distill_epoch(conf, model, optimizer, x, t, labels,
                                      idx_l, idx_t,
                                      place.generators(conf, device))
    evaluators = place.evaluators(conf, model, labels.shape[0])
    return _tran_tail(conf, model, logger, loss_and_score, state_out,
                      train_epoch, lambda exact: evaluators[exact](None, x),
                      labels, (idx_l, idx_val, idx_test),
                      ("s_l", "s_val", "s_test"), "distill runner")


def distill_run_inductive(conf, model, feats, labels, out_t_all,
                          distill_indices, optimizer, logger,
                          loss_and_score, device, state_out=None,
                          place=LOCAL):
    """GLNN distillation, inductive: the soft-label set is the observed
    train + val + test only. `distill_indices` = (obs_idx_l, obs_idx_t,
    obs_idx_val, obs_idx_test, idx_obs, idx_test_ind); the passes train on
    the observed rows' global ids. One eval on all features; the obs rows
    are taken by idx_obs. Returns (out, score_val, score_test_tran,
    score_test_ind). Under a rank's placement feats and out_t_all are the
    rank's row blocks."""
    x, labels, t = _tensors(device, np.asarray(feats, np.float32), labels,
                            np.asarray(out_t_all, np.float32))
    (obs_idx_l, obs_idx_t, obs_idx_val, obs_idx_test, idx_obs,
     idx_test_ind) = _tensors(device, *distill_indices)
    train_epoch = place.distill_epoch(conf, model, optimizer, x, t, labels,
                                      idx_obs[obs_idx_l], idx_obs[obs_idx_t],
                                      place.generators(conf, device))
    evaluate = _one_pass(place.evaluators(conf, model, labels.shape[0]), x,
                         idx_obs)
    return _ind_tail(conf, model, logger, loss_and_score, state_out,
                     train_epoch, evaluate, labels, idx_obs,
                     (obs_idx_l, obs_idx_val, obs_idx_test, idx_test_ind),
                     ("s_l", "s_val", "s_tt", "s_ti"), "distill runner")
