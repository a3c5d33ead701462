"""Train/eval functions and the transductive runners
(`glnn_tpu/train/engine.py`).

* `make_gnn_train_step`: the full-batch GNN step (GCN, GAT, APPNP, and SAGE
  with --sage_sampling full): NLL on idx_train, Adam step; the runner's
  generator draws every dropout mask, APPNP's per-hop edge drop included.
* `make_eval_fn`: all-node log-probs in eval mode. Intermediate evals are
  marked `ops.inference_mode()`, so on CUDA the auto backend takes the int8
  SpMM tier; `exact=True` (the final eval, whose log-probs become out.npz
  and the student's KL targets) leaves the mark off.
* `make_mlp_epoch_fn`: shuffled fixed-size minibatches with the tail
  remainder dropped, max(1, n // batch_size) batches.
* `make_mlp_eval_fn`: chunked eval, no tail dropping.
* Runners: eval every `eval_interval` epochs, best snapshot on
  score_val >= best (ties refresh it), early stop when count == patience,
  restore the best before the final eval. Distillation runs two optimizer
  passes per epoch (hard labels scaled by lamb, then teacher log-probs
  scaled by 1 - lamb); Adam advances on the zero-scaled pass too.

The inductive runners are not ported yet (ROADMAP queue A item 5).
"""

from __future__ import annotations

import math
from functools import partial

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
from glnn_tpu_torch.utils.profiling import StepTimer


def make_gnn_train_step(model, optimizer):
    """step(g, feats, labels, idx_train, gen) -> loss (a device scalar):
    a training-mode forward over the whole graph with its dropout masks
    drawn from `gen`, NLL on idx_train, one optimizer step."""

    def step(g, feats, labels, idx_train, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = log_softmax(model(g, feats, gen)[1])
        loss = nll_loss(out[idx_train], labels[idx_train])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_fn(model, exact: bool = False):
    """evaluate(g, feats) -> all-node log-probs (eval mode, no grad)."""

    @torch.no_grad()
    def evaluate(g, feats):
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
        return float(torch.stack(losses).mean())

    return epoch


def make_mlp_eval_fn(model, batch_size: int | None = None):
    """evaluate(feats) -> all-node log-probs, in chunks of `batch_size` rows
    (eval mode is row-independent, so chunks equal the full forward)."""

    @torch.no_grad()
    def evaluate(feats):
        model.eval()
        step = feats.shape[0] if batch_size is None else batch_size
        return torch.cat([log_softmax(model(None, feats[i:i + step])[1])
                          for i in range(0, feats.shape[0], step)])

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
    return float(nll_loss(sub, lab)), float(accuracy(sub, lab))


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


def run_transductive(conf, model, g, feats, labels, indices, optimizer,
                     logger, loss_and_score, device):
    """Teacher training, transductive: an MLP, a sampled-SAGE or a
    full-batch GNN (GCN, GAT, APPNP, full SAGE) teacher on `device`. Returns
    (out, score_val, score_test) with `out` the all-node log-probs (numpy)
    from the best checkpoint."""
    feats, labels = _tensors(device, np.asarray(feats, np.float32), labels)
    idx_train, idx_val, idx_test = _tensors(device, *indices)
    gen = torch.Generator(device=device).manual_seed(int(conf["seed"]))

    is_mlp = model.is_mlp
    sampled = _use_sampled_sage(conf, model)
    if is_mlp:
        epoch_fn = make_mlp_epoch_fn(model, optimizer, conf["batch_size"],
                                     "nll")
        eval_fn = make_mlp_eval_fn(
            model, conf.get("eval_batch_size", conf["batch_size"]))
        final_fn = eval_fn
        feats_train, labels_train = feats[idx_train], labels[idx_train]
    else:
        if sampled:
            epoch_fn = make_sage_sampled_epoch_fn(
                model, optimizer, conf["batch_size"], _fanouts(conf))
        else:
            step_fn = make_gnn_train_step(model, optimizer)
        eval_fn = partial(make_eval_fn(model), g)
        # the final log-probs become out.npz, the student's KL targets:
        # always the exact tier
        final_fn = partial(make_eval_fn(model, exact=True), g)

    tracker = _BestTracker(model)
    timer = StepTimer()
    for epoch in range(1, conf["max_epoch"] + 1):
        with timer:
            if is_mlp:
                loss = epoch_fn(feats_train, labels_train, gen)
            elif sampled:
                loss, overflow = epoch_fn(g, feats, labels, idx_train, gen)
                if overflow:
                    logger.warning(f"Ep {epoch}: sampler frontier cap overflow")
            else:
                # sync before the timer reads, as the JAX runner does
                loss = float(step_fn(g, feats, labels, idx_train, gen))
        _debug_guard(conf, loss, epoch, "teacher tran runner")
        if epoch % conf["eval_interval"] == 0:
            out = eval_fn(feats)
            loss_train, score_train = _subset_metrics(out, labels, idx_train)
            loss_val, score_val = _subset_metrics(out, labels, idx_val)
            loss_test, score_test = _subset_metrics(out, labels, idx_test)
            logger.debug(
                f"Ep {epoch:3d} | loss: {loss:.4f} | "
                f"s_train: {score_train:.4f} | s_val: {score_val:.4f} | "
                f"s_test: {score_test:.4f}"
            )
            loss_and_score.append([epoch, loss_train, loss_val, loss_test,
                                   score_train, score_val, score_test])
            tracker.update(epoch, score_val, model)

        if tracker.count == conf["patience"] or epoch == conf["max_epoch"]:
            break

    logger.info(
        f"mean epoch time: {timer.mean * 1e3:.1f} ms over {timer.count} epochs")
    restore(model, tracker.snap)
    out = final_fn(feats)
    _, score_val = _subset_metrics(out, labels, idx_val)
    _, score_test = _subset_metrics(out, labels, idx_test)
    logger.info(
        f"Best valid model at epoch: {tracker.best_epoch: 3d}, "
        f"score_val: {score_val:.4f}, score_test: {score_test:.4f}"
    )
    return out.cpu().numpy(), score_val, score_test


def distill_run_transductive(conf, model, feats, labels, out_t_all,
                             distill_indices, optimizer, logger,
                             loss_and_score, device):
    """GLNN distillation, transductive: per epoch a hard-label pass on idx_l
    scaled by lamb, then a teacher log-prob pass on idx_t scaled by
    1 - lamb. Returns (out, score_val, score_test)."""
    lamb = conf["lamb"]
    feats, labels, out_t_all = _tensors(
        device, np.asarray(feats, np.float32), labels,
        np.asarray(out_t_all, np.float32))
    idx_l, idx_t, idx_val, idx_test = _tensors(device, *distill_indices)
    feats_l, labels_l = feats[idx_l], labels[idx_l]
    feats_t, out_t = feats[idx_t], out_t_all[idx_t]
    gen = torch.Generator(device=device).manual_seed(int(conf["seed"]))

    batch_size = conf["batch_size"]
    hard_epoch = make_mlp_epoch_fn(model, optimizer, batch_size, "nll",
                                   lamb=lamb)
    soft_epoch = make_mlp_epoch_fn(model, optimizer, batch_size, "kl",
                                   lamb=1.0 - lamb)
    eval_fn = make_mlp_eval_fn(model, conf.get("eval_batch_size", batch_size))

    tracker = _BestTracker(model)
    timer = StepTimer()
    for epoch in range(1, conf["max_epoch"] + 1):
        with timer:
            loss = (hard_epoch(feats_l, labels_l, gen)
                    + soft_epoch(feats_t, out_t, gen))
        _debug_guard(conf, loss, epoch, "distill runner")
        if epoch % conf["eval_interval"] == 0:
            out = eval_fn(feats)
            # the logged loss_l is the eval-mode NLL on the hard-label set
            loss_l_ev, score_l = _subset_metrics(out, labels, idx_l)
            loss_val, score_val = _subset_metrics(out, labels, idx_val)
            loss_test, score_test = _subset_metrics(out, labels, idx_test)
            logger.debug(
                f"Ep {epoch:3d} | loss: {loss:.4f} | s_l: {score_l:.4f} | "
                f"s_val: {score_val:.4f} | s_test: {score_test:.4f}"
            )
            loss_and_score.append([epoch, loss_l_ev, loss_val, loss_test,
                                   score_l, score_val, score_test])
            tracker.update(epoch, score_val, model)

        if tracker.count == conf["patience"] or epoch == conf["max_epoch"]:
            break

    logger.info(
        f"mean epoch time: {timer.mean * 1e3:.1f} ms over {timer.count} epochs")
    restore(model, tracker.snap)
    out = eval_fn(feats)
    _, score_val = _subset_metrics(out, labels, idx_val)
    _, score_test = _subset_metrics(out, labels, idx_test)
    logger.info(
        f"Best valid model at epoch: {tracker.best_epoch: 3d}, "
        f"score_val: {score_val:.4f}, score_test: {score_test:.4f}"
    )
    return out.cpu().numpy(), score_val, score_test
