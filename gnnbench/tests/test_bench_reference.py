"""The plain reference against the port at tiny shapes on the CPU, the
control (the reference one precision step down, in the port's place),
and the faults the check has to catch, each driving a whole run with the
timed path broken underneath."""

import pytest
import torch

from gnnbench import check
from gnnbench.reference import CONTROL, EXACT
from gnnbench.tests import tiny

TRAINING = ("arxiv-gat-powerlaw",)


@pytest.fixture(autouse=True)
def _kernel_tier(monkeypatch):
    tiny.kernel_tier(monkeypatch)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_port_agrees_with_reference(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_refused(cell):
    lp = tiny.loop(cell)
    numbers = lp.check(CONTROL)
    ok, table = check.judge(numbers, lp.cell["limits"])
    assert not ok, table


@pytest.mark.parametrize("cell", TRAINING)
def test_reference_half_batch_is_refused(cell):
    lp = tiny.loop(cell)
    ok, table = check.judge(lp.check(EXACT, "half_batch"), lp.cell["limits"])
    assert not ok, table


class _NoStep(torch.optim.Adam):
    def step(self, closure=None):
        return None


@pytest.mark.parametrize("cell", TRAINING)
def test_fault_state_unchanged(cell, monkeypatch):
    from glnn_tpu_torch.train import state

    monkeypatch.setattr(state, "make_adam", lambda params, lr, wd: _NoStep(
        params, lr=lr, weight_decay=wd))
    res = tiny.run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.5


def _first_half(fn):
    def half(a, b):
        k = a.shape[0] // 2
        return fn(a[:k], b[:k])
    return half


@pytest.mark.parametrize("cell", TRAINING)
def test_fault_half_batch(cell, monkeypatch):
    from glnn_tpu_torch.train import engine

    monkeypatch.setattr(engine, "nll_loss", _first_half(engine.nll_loss))
    res = tiny.run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_fault_answer_altered(cell, monkeypatch):
    from glnn_tpu_torch.train import engine

    orig = engine.log_softmax

    def altered(h):
        out = orig(h)
        if not torch.is_grad_enabled():
            out = out.clone()
            out[0, 0] += 0.25
        return out

    monkeypatch.setattr(engine, "log_softmax", altered)
    res = tiny.run(cell)
    assert not res["correct"], res["checks"]
