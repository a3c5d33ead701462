"""Readings of the port's own training object, taken by hooks while the
set-up drives its first steps through the window's own calls.

The hooks sit on the objects the benchmark builds and hands to the
runner: the model (a forward hook: the logits of each training forward)
and the optimizer (step pre- and post-hooks: the first gradient as the
optimizer gets it, and the state after the last step read). They cover
the first `n_steps` optimizer steps from the initial state and are
removed before the window opens.
"""

from __future__ import annotations

import torch


class Capture:
    def __init__(self, model, optimizer, start: dict, n_steps: int,
                 weight_decay: float):
        self.model, self.n_steps, self.wd = model, n_steps, float(weight_decay)
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.steps = 0
        self.stage = {"steps": [], "grad": None, "end": None,
                      "start": {k: v.clone() for k, v in start.items()}}
        self.handles = [
            model.register_forward_hook(self._post),
            optimizer.register_step_pre_hook(self._step_pre),
            optimizer.register_step_post_hook(self._step_post)]

    def _post(self, module, args, output):
        if module.training and len(self.stage["steps"]) < self.n_steps:
            self.stage["steps"].append(
                {"logits": output[1].detach().float().clone()})

    def _step_pre(self, optimizer, args, kwargs):
        if self.steps:
            return
        grads = {}
        for group in optimizer.param_groups:
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                grads[self.names[id(p)]] = (g + self.wd * p.detach()).clone()
        self.stage["grad"] = grads

    def _step_post(self, optimizer, args, kwargs):
        self.steps += 1
        if self.steps == self.n_steps:
            self.stage["end"] = {k: v.detach().clone()
                                 for k, v in self.model.state_dict().items()}

    @property
    def done(self) -> bool:
        return self.stage["end"] is not None

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
