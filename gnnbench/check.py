"""The numbers that decide `correct`, each held to its limit.

Of a training stage (the port's readings against the reference's):
  loss_gap:   worst step's |loss - reference loss| / |reference loss|
              (".first": the first step's, before any update); the
              port's loss is taken from its logits by the runner's rule
              (`reference.train.loss_of`) on the reference's batch;
  logit_gap:  worst step's max |logit - reference| / max |reference|
              (".first" as above);
  logit_rms:  worst step's |logits - reference| / |reference| (norms over
              all logits of the step; ".first" as above): a rounding flip
              moves a few logits, a wrong step moves them all;
  grad_gap:   worst leaf's | |g| - |g_ref| | / max(|g_ref|, median leaf
              |g_ref|), g the first gradient as the optimizer gets it
              (".median": the median leaf's gap);
  change_gap: the same of each leaf's change over the stage (parameters
              and batch-norm statistics). Parameters whose reference
              gradient is under a thousandth of the median leaf's are left
              out: Adam moves them by round-off alone.
Of an eval or a served request: eval_gap / request_gap, the widest
|log-prob - reference|. Of the graph: graph_mismatch, entries that differ.
"""

from __future__ import annotations

import math
import statistics

import torch

from gnnbench.reference.train import is_stat, loss_of

TINY = 1e-30


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _leaf_gaps(port: dict, ref: dict, leaves) -> dict:
    """{leaf: | |port| - |ref| | / max(|ref|, median leaf |ref|)}."""
    ref_norms = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(ref_norms.values()) if ref_norms else 0.0
    out = {}
    for k in leaves:
        if k not in port or port[k].shape != ref[k].shape:
            out[k] = math.inf
            continue
        base = max(ref_norms[k], med, TINY)
        out[k] = abs(_norm(port[k]) - ref_norms[k]) / base
    return out


def _worst_and_median(name: str, gaps: dict, out: dict) -> None:
    vals = list(gaps.values()) or [math.inf]
    out[name] = max(vals)
    out[name + ".median"] = statistics.median(vals)


def compare_stage(port: dict, ref: dict, detail: dict | None = None) -> dict:
    """The numbers of one stage; `port` and `ref` as `capture` and
    `reference.train` give them. Beside each worst value: ".first", the
    first step's, and ".median", the median leaf's. `detail`, when
    given, receives every step's and every leaf's gap."""
    names = ("loss_gap", "logit_gap", "logit_rms", "grad_gap", "change_gap")
    if len(port["steps"]) != len(ref["steps"]):
        return {k + sfx: math.inf for k in names
                for sfx in ("", ".first" if k in names[:3] else ".median")}
    losses, logits, rms = [], [], []
    for ps, rs in zip(port["steps"], ref["steps"]):
        zp, zr = ps["logits"], rs["logits"].float()
        if zp is None or zp.shape != zr.shape:
            losses.append(math.inf)
            logits.append(math.inf)
            rms.append(math.inf)
            continue
        zp = zp.to(zr.device)
        logits.append(float((zp - zr).abs().max())
                      / max(float(zr.abs().max()), TINY))
        rms.append(_norm(zp - zr) / max(_norm(zr), TINY))
        lp = float(loss_of(zp, rs["target"]))
        losses.append(abs(lp - rs["loss"]) / max(abs(rs["loss"]), TINY))
    out = {"loss_gap": max(losses), "loss_gap.first": losses[0],
           "logit_gap": max(logits), "logit_gap.first": logits[0],
           "logit_rms": max(rms), "logit_rms.first": rms[0]}
    grad_leaves = list(ref["grad"])
    grads = ({k: math.inf for k in grad_leaves} if port["grad"] is None
             else _leaf_gaps(port["grad"], ref["grad"], grad_leaves))
    _worst_and_median("grad_gap", grads, out)
    gnorm = {k: _norm(ref["grad"][k]) for k in grad_leaves}
    med = statistics.median(gnorm.values()) if gnorm else 0.0
    moved = [k for k in ref["end"]
             if is_stat(k) or gnorm.get(k, 0.0) >= 1e-3 * med]
    if port["end"] is None or port["start"] is None:
        changes = {k: math.inf for k in moved}
    else:
        dev = {k: ref["end"][k].device for k in moved}
        dp = {k: port["end"][k].to(dev[k]).float()
              - port["start"][k].to(dev[k]).float()
              for k in moved if k in port["end"] and k in port["start"]}
        dr = {k: ref["end"][k].float() - ref["start"][k].float()
              for k in moved}
        changes = _leaf_gaps(dp, dr, moved)
    _worst_and_median("change_gap", changes, out)
    if detail is not None:
        detail.update(steps_loss=losses, steps_logit=logits, steps_rms=rms,
                      grad=grads,
                      change=changes,
                      left_out=sorted(set(ref["end"]) - set(moved)))
    return out


def max_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    if port is None or tuple(port.shape) != tuple(ref.shape):
        return math.inf
    d = (port.to(ref.device).float() - ref.float()).abs()
    if not bool(torch.isfinite(port).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each finite and at most its limit; a limit whose number is
    missing fails. Numbers without a limit are not judged."""
    table, ok = {}, True
    for name in sorted(limits):
        v, lim = numbers.get(name), limits[name]
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        table[name] = {"value": v, "limit": lim}
    return ok, table
