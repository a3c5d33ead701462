"""The reader of the weighted walks' gather counter
(`metrics/weighted_gather_share.train`): the share from stubbed counts,
silent in the serve role, where no weighted walk ran, and for a program
without the counter."""

import pytest

from gnnbench import find
from glnn_tpu_torch.ops import spmm_cuda

TRAIN = {"loop": "teacher_epochs", "role": "train", "calls": 2}
SERVE = {"loop": "serve_closed", "role": "serve", "calls": 2}


def _read(ctx):
    return find.module("metrics", "weighted_gather_share.train").read(
        dict(ctx))


def test_reader_gives_the_gathered_share(monkeypatch):
    monkeypatch.setattr(spmm_cuda, "gather_counts",
                        lambda: {"walked": 400, "gathered": 198})
    assert _read(TRAIN) == pytest.approx(49.5)


def test_reader_is_silent_for_serve_and_no_walks(monkeypatch):
    monkeypatch.setattr(spmm_cuda, "gather_counts",
                        lambda: {"walked": 400, "gathered": 198})
    assert _read(SERVE) is None
    monkeypatch.setattr(spmm_cuda, "gather_counts",
                        lambda: {"walked": 0, "gathered": 0})
    assert _read(TRAIN) is None


def test_reader_is_silent_for_a_program_without_the_counter(monkeypatch):
    """The parent commit's program has no `gather_counts`."""
    monkeypatch.delattr(spmm_cuda, "gather_counts")
    assert _read(TRAIN) is None
