"""The readers of the program's spans (`metrics/host_read_ms.train`,
`host_reads.train`, `wrapper_host_ms.train`, `eval_host_ms.serve`): each
over a hand-filled span list, silent for the other role and for no spans,
and a traced run of each cell at its tiny shapes that reports them."""

import pytest

from gnnbench import find
from gnnbench.tests import tiny
from glnn_tpu_torch.utils import profiling

MS = 1_000_000
R = profiling.SpanRecord
# two traced epochs of a teacher and two requests of the student
SPANS = [
    R("runner.train_epoch", 0, 10 * MS, -1, 0, 1, 0),
    R("runner.forward", 1 * MS, 4 * MS, 0, 0, 1, 1),
    R("kernel.gat_fwd", 2 * MS, 3 * MS, 1, 0, 1, 2),
    R("plan.hub_plan", 2 * MS, int(2.5 * MS), 2, 0, 1, 3),
    R("kernel.gat_bwd", 5 * MS, 7 * MS, -1, 0, 2, 4),
    R("runner.host_read", 8 * MS, 10 * MS, 0, 0, 1, 5),
    R("runner.metrics_row", 11 * MS, 14 * MS, -1, 6, 1, 6),
    R("runner.host_read", 11 * MS, 12 * MS, 6, 6, 1, 7),
    R("runner.host_read", 12 * MS, 14 * MS, 6, 6, 1, 8),
    R("runner.eval", 20 * MS, 23 * MS, -1, 9, 1, 9),
    R("runner.eval", 30 * MS, 31 * MS, -1, 10, 1, 10),
]
TRAIN = {"loop": "teacher_epochs", "role": "train", "calls": 2}
SERVE = {"loop": "serve_closed", "role": "serve", "calls": 2}
# reader: (its context, its value over SPANS)
WANT = {
    "host_read_ms.train": (TRAIN, (2 + 1 + 2) / 2),
    "host_reads.train": (TRAIN, 3 / 2),
    # gat_fwd's 1 ms less its plan build's 0.5, and gat_bwd's 2 ms
    "wrapper_host_ms.train": (TRAIN, (0.5 + 2) / 2),
    "eval_host_ms.serve": (SERVE, (3 + 1) / 2),
}


@pytest.fixture()
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_log", fresh)
    return fresh


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_gives_the_per_call_value(metric, log):
    log.records[:] = SPANS
    ctx, want = WANT[metric]
    assert find.module("metrics", metric).read(dict(ctx)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_silent_for_the_other_role_and_no_spans(metric, log):
    read = find.module("metrics", metric).read
    ctx, _ = WANT[metric]
    other = SERVE if ctx is TRAIN else TRAIN
    log.records[:] = SPANS
    assert read(dict(other)) is None
    assert read(dict(ctx, calls=0)) is None
    log.records[:] = []
    assert read(dict(ctx)) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_silent_for_a_program_without_spans(metric, log,
                                                      monkeypatch):
    """The parent commit's program has no `span_totals`."""
    log.records[:] = SPANS
    monkeypatch.delattr(profiling, "span_totals")
    ctx, _ = WANT[metric]
    assert find.module("metrics", metric).read(dict(ctx)) is None


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_run_reports_the_span_metrics(cell, log, monkeypatch):
    tiny.kernel_tier(monkeypatch)
    res = tiny.run(cell, traced=True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if cell == "arxiv-gat-powerlaw":
        assert got["host_reads.train"] == 7.0
        assert 0.0 < got["host_read_ms.train"]
        assert 0.0 < got["wrapper_host_ms.train"]
        assert "eval_host_ms.serve" not in got
    else:
        assert 0.0 < got["eval_host_ms.serve"]
        assert not {"host_reads.train", "host_read_ms.train",
                    "wrapper_host_ms.train"} & set(got)
    assert res["correct"]
