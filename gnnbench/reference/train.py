"""The reference's training steps and evals, and the readings the check
compares.

A stage starts from the initial state (parameters, and batch-norm
statistics where the model has them) and follows the runner's first
steps, each drawing the forward's dropout draws (`models`) from the one
generator of the run. Adam is torch.optim.Adam (betas 0.9, 0.999, eps
1e-8, L2 weight decay added to the gradient).

Readings of a stage (the port's are taken alike by `capture`):
  steps[k]: {"loss", "logits"} of its k-th step; "target" says how the
            loss is taken from the logits;
  grad:     each parameter's first gradient as the optimizer gets it
            (gradient + weight decay * parameter);
  start, end: the state before the stage and after its last step.
"""

from __future__ import annotations

import torch

from gnnbench.reference import models
from gnnbench.reference.precision import Precision

STATS = ("running_mean", "running_var")


def log_softmax(h):
    return torch.log_softmax(h.float(), dim=-1)


def loss_of(logits, target: dict) -> torch.Tensor:
    """The loss the runner takes from a step's logits: the mean NLL over
    the target's rows; with "first" set, over its first rows alone (a
    fault the check must catch)."""
    if target["kind"] != "nll":
        raise ValueError(target["kind"])
    rows, y = target["rows"], target["y"]
    first = target.get("first")
    if first is not None:
        rows, y = rows[:first], y[:first]
    return -log_softmax(logits)[rows].gather(1, y.long()[:, None]).mean()


def is_stat(name: str) -> bool:
    return name.endswith(STATS)


class _Learner:
    """Parameters, statistics and Adam of one stage."""

    def __init__(self, state: dict, recipe: dict):
        self.p = {k: v.detach().clone() for k, v in state.items()}
        self.leaves = [k for k in self.p if not is_stat(k)]
        for k in self.leaves:
            self.p[k].requires_grad_(True)
        self.wd = float(recipe["weight_decay"])
        self.opt = torch.optim.Adam([self.p[k] for k in self.leaves],
                                    lr=recipe["learning_rate"],
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.wd)
        self.grad = None

    def step(self, loss_scaled):
        self.opt.zero_grad(set_to_none=True)
        loss_scaled.backward()
        if self.grad is None:
            self.grad = {k: (self.p[k].grad + self.wd * self.p[k].detach())
                         .detach().clone() for k in self.leaves}
        self.opt.step()

    def state(self) -> dict:
        return {k: v.detach().clone() for k, v in self.p.items()}


def _faulty(target: dict, fault) -> dict:
    """The target a planted fault trains on: "half_batch" leaves out the
    second half of the batch and takes the mean over the rest."""
    if fault is None:
        return target
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    return dict(target, first=target["rows"].shape[0] // 2)


def _readings(learner, start, steps):
    return {"steps": steps, "grad": learner.grad, "start": start,
            "end": learner.state()}


def follow_full_batch(state, recipe, graph, feats, labels, idx_train, gen,
                      n_steps, prec: Precision, fault=None):
    """Full-batch steps: NLL over the train rows of the whole graph's
    logits, the model's forward found by its name
    (`models.graph_forward`)."""
    forward = models.graph_forward(recipe["model_name"])
    learner = _Learner(state, recipe)
    start = learner.state()
    steps = []
    target = {"kind": "nll", "y": labels[idx_train], "rows": idx_train}
    for _ in range(n_steps):
        logits = forward(learner.p, recipe, graph, feats, True, gen, prec)
        loss = loss_of(logits, _faulty(target, fault))
        learner.step(loss)
        steps.append({"loss": float(loss.detach()), "logits": logits.detach(),
                      "target": target})
    return _readings(learner, start, steps)


@torch.no_grad()
def eval_log_probs(state, recipe, x, prec: Precision, graph=None,
                   chunk: int = 1 << 18):
    """All-node (or all-row) eval log-probs; an MLP in chunks of rows."""
    p = {k: v.detach() for k, v in state.items()}
    name = recipe["model_name"]
    if name == "MLP":
        return torch.cat([log_softmax(models.mlp(p, recipe, x[i:i + chunk],
                                                 False, None, prec))
                          for i in range(0, x.shape[0], chunk)])
    return log_softmax(models.graph_forward(name)(p, recipe, graph, x, False,
                                                  None, prec))
