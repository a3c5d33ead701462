"""The reader of `eval_graph_share.serve` (`metrics/eval_graph_share.serve`)
over planted span records: the share of `runner.eval` calls with a replay,
silent for the teacher's role, without either span, and for a program
without spans; and absent from a traced run on the CPU, where the eval runs
eagerly."""

import pytest

from gnnbench import find
from gnnbench.tests import tiny
from glnn_tpu_torch.utils import profiling

MS = 1_000_000
R = profiling.SpanRecord
SERVE = {"loop": "serve_closed", "role": "serve", "calls": 4}
TRAIN = {"loop": "teacher_epochs", "role": "train", "calls": 4}


def _requests(replayed: int, eager: int) -> list:
    """`replayed` eval calls with a replay inside, then `eager` without."""
    recs, rid = [], 0
    for i in range(replayed + eager):
        recs.append(R("runner.eval", 10 * i * MS, (10 * i + 3) * MS, -1, rid,
                      1, rid))
        if i < replayed:
            recs.append(R("runner.eval_graph", (10 * i + 1) * MS,
                          (10 * i + 2) * MS, rid, rid, 1, rid + 1))
        rid += 2
    return recs


@pytest.fixture()
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_log", fresh)
    return fresh


def _read():
    return find.module("metrics", "eval_graph_share.serve").read


@pytest.mark.parametrize("replayed,eager,want", [(4, 0, 100.0), (3, 1, 75.0),
                                                 (1, 3, 25.0)])
def test_share_of_eval_calls_that_replayed(log, replayed, eager, want):
    log.records[:] = _requests(replayed, eager)
    assert _read()(dict(SERVE)) == pytest.approx(want)


def test_silent_without_the_span_or_for_the_teacher(log):
    read = _read()
    log.records[:] = _requests(0, 4)
    assert read(dict(SERVE)) is None
    log.records[:] = []
    assert read(dict(SERVE)) is None
    log.records[:] = _requests(4, 0)
    assert read(dict(TRAIN)) is None


def test_silent_for_a_program_without_spans(log, monkeypatch):
    log.records[:] = _requests(4, 0)
    monkeypatch.delattr(profiling, "span_totals")
    assert _read()(dict(SERVE)) is None


def test_traced_serving_run_on_the_cpu_leaves_it_out(log):
    res = tiny.run("products-mlp-serve", traced=True)
    assert "eval_graph_share.serve" not in res["metrics"]
    assert res["metrics"]["eval_host_ms.serve"]["value"] > 0.0
    assert res["correct"]
