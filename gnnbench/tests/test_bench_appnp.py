"""The APPNP cell's pieces: `models/APPNP.py`'s bytes and FLOPs worked by
hand at a tiny shape, the three readers it adds (`spmm_weighted_roofline`,
`spmm_int8_roofline`, `propagate_host_ms.train`) with their silent cases,
and the cell itself at tiny shapes on the CPU (the kernel tiers' plain
versions in the kernels' place): it finds its pieces, agrees with the
reference, refuses the control and the half-batch fault, and reports the
span metric in a traced run."""

import time

import pytest
import torch

from gnnbench import check, find, work
from gnnbench.harness import find_cell, loop_class
from gnnbench.reference import CONTROL, EXACT
from gnnbench.tests import tiny
from glnn_tpu_torch.utils import profiling

CELL = "arxiv-appnp-teacher"
SCALE = {"dataset": {"n_nodes": 2000, "split": [900, 300, 800],
                     "degree_law": {"kind": "power_law",
                                    "directed_edges": 14000,
                                    "exponent": 3.0}}}
APPNP = work.model_work("APPNP")
RECIPE = {"num_layers": 2, "hidden_dim": 4, "k": 3, "norm_type": "none"}
DS = {"n_nodes": 3, "n_feats": 5, "n_classes": 2}


def test_hop_ops_by_hand():
    # 3 rows, 7 edges, 2 columns: indptr 4 x 4 B, sources 7 x 4, x f32
    # 3 x 2 x 4, weights 7 x 4; out f32 3 x 2 x 4
    assert APPNP.weighted_op(3, 7, 2) == (16 + 28 + 24 + 28 + 24, 28)
    # transposed: t_indptr, each slot's dst and edge, dh f32, weights; out
    assert APPNP.weighted_t_op(3, 7, 2) == (16 + 28 + 28 + 24 + 28 + 24, 28)
    # int8: indptr, sources, q 3 x 2 x 1, scale 2 x 4; out f32
    assert APPNP.int8_op(3, 7, 2) == (16 + 28 + 6 + 8 + 24, 14)


def test_hop_bytes_at_the_cell_shape():
    """One forward weighted hop at N = 169,343, F = 40, E = 2,501,829
    moves 74.9 MB, 22 us at 3.35 TB/s."""
    b, f = APPNP.weighted_op(169343, 2501829, 40)
    assert b == pytest.approx(74.88e6, rel=1e-3)
    assert work.least_seconds(b, f) == pytest.approx(22.35e-6, rel=1e-3)


def test_epoch_flops_and_ops_by_hand():
    # head 5 -> 4 -> 2 over 3 rows: forward 2*3*(20 + 8) = 168; backward
    # weight gradients 168, input gradient of layer 1 2*3*8 = 48; the
    # eval's forward 168; 2 k weighted hops of 2*7*2 = 28, k int8 of 14
    assert APPNP.mlp_flops(RECIPE, 5, 2, 3, train=False) == 168
    assert APPNP.mlp_flops(RECIPE, 5, 2, 3) == 168 + 168 + 48
    assert APPNP.epoch_flops(RECIPE, DS, 7) == (168 + 168 + 48 + 168
                                                + 6 * 28 + 3 * 14)
    ops = APPNP.epoch_ops(RECIPE, DS, 7)
    assert ops == {"spmm_csr_weighted": [APPNP.weighted_op(3, 7, 2)] * 3
                   + [APPNP.weighted_t_op(3, 7, 2)] * 3,
                   "spmm_csr_int8": [APPNP.int8_op(3, 7, 2)] * 3}


def test_weights_follow_the_linear_law():
    spec = APPNP.weight_spec(RECIPE, 5, 2)
    assert [name for name, *_ in spec] == [
        "module.layers.0.weight", "module.layers.0.bias",
        "module.layers.1.weight", "module.layers.1.bias"]
    assert spec[0][1:] == ((4, 5), ("uniform", -5 ** -0.5, 5 ** -0.5))
    assert spec[3][1:] == ((2,), ("uniform", -0.5, 0.5))


def _ctx(**over):
    trace = {"busy_s": 0.5, "window_s": 1.0,
             "ops": {"spmm_csr_weighted": 4e-3, "spmm_csr_int8": 1e-3}}
    ctx = {"loop": "teacher_epochs", "role": "train", "trace": trace,
           "spans": {}, "calls": 2, "dtype": "float32",
           "ops": {"spmm_csr_weighted": [(3.35e9, 0.0)] * 2,
                   "spmm_csr_int8": [(3.35e8, 0.0)]}}
    return dict(ctx, **over)


@pytest.mark.parametrize("metric,kernel,want", [
    # two traced epochs, each two calls of 1 ms least: 4 ms of 4 ms
    ("spmm_weighted_roofline", "spmm_csr_weighted", 100.0),
    # two traced epochs of one 0.1 ms call in 1 ms
    ("spmm_int8_roofline", "spmm_csr_int8", 20.0)])
def test_rooflines_read_their_kernel(metric, kernel, want):
    read = find.module("metrics", metric).read
    assert read(_ctx()) == pytest.approx(want)
    # silent: no trace, the op not traced, the op not counted
    assert read(_ctx(trace=None)) is None
    assert read(_ctx(trace={"busy_s": 0.5, "window_s": 1.0,
                            "ops": {}})) is None
    assert read(_ctx(ops={})) is None


@pytest.fixture()
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_log", fresh)
    return fresh


def test_propagate_reader_and_its_silence(log, monkeypatch):
    ms = 1_000_000
    R = profiling.SpanRecord
    read = find.module("metrics", "propagate_host_ms.train").read
    log.records[:] = [R("model.APPNP.propagate", 0, 3 * ms, -1, 0, 1, 0),
                      R("model.APPNP.edge_drop", ms, 2 * ms, 0, 0, 1, 1),
                      R("model.APPNP.propagate", 5 * ms, 6 * ms, -1, 2, 1, 2)]
    assert read(_ctx()) == pytest.approx((3 + 1) / 2)
    assert read(_ctx(role="serve", loop="serve_closed")) is None
    assert read(_ctx(calls=0)) is None
    log.records[:] = []
    assert read(_ctx()) is None
    # the parent commit's program: spans without this one, or none at all
    log.records[:] = [R("runner.eval", 0, ms, -1, 0, 1, 0)]
    assert read(_ctx()) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert read(_ctx()) is None


def test_cell_finds_its_pieces():
    c = find_cell(tiny.ROOT, CELL)
    assert c["config_data"]["teacher"]["model_name"] == "APPNP"
    assert loop_class(c).metric == "teacher_epoch_ms"
    assert {m["name"] for m in c["end_to_end"]} == {"setup_s",
                                                    "teacher_epoch_ms"}
    layer = {m["name"] for m in c["per_layer"]}
    assert {"spmm_weighted_roofline", "spmm_int8_roofline",
            "propagate_host_ms.train", "teacher_mfu", "device_ms.train",
            "device_idle_share.train", "wrapper_host_ms.train"} <= layer
    assert not {"gat_fwd_roofline", "gat_bwd_roofline"} & layer
    assert set(c["limits"]) == {"graph_mismatch", "loss_gap", "logit_rms",
                                "grad_gap", "change_gap", "eval_gap"}
    assert find.module("reference", "APPNP").forward


def _loop():
    c = find_cell(tiny.ROOT, CELL)
    lp = loop_class(c)(c, 2 ** 31 + 12345, torch.device("cpu"), tiny.ROOT,
                       {}, SCALE)
    lp.setup()
    lp.window(0.3)
    lp.release()
    return lp


def test_tiny_cell_agrees_and_refuses_the_control_and_the_fault(
        monkeypatch):
    tiny.kernel_tier(monkeypatch)
    lp = _loop()
    limits = lp.cell["limits"]
    ok, table = check.judge(lp.check(), limits)
    assert ok, table
    for args in ((CONTROL,), (EXACT, "half_batch")):
        ok, table = check.judge(lp.check(*args), limits)
        assert not ok, (args, table)


def test_tiny_traced_run_reports_the_propagate_span(log, monkeypatch):
    from gnnbench.harness import run_cell

    tiny.kernel_tier(monkeypatch)
    res = run_cell(tiny.ROOT, CELL, 2 ** 31 + 99, 0.3, True,
                   torch.device("cpu"), time.perf_counter(), scale=SCALE,
                   emit=lambda line: None)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"], res["checks"]
    assert 0.0 < got["propagate_host_ms.train"]
    assert got["host_reads.train"] == 7.0
    # a CPU trace names no port kernel: the rooflines stay silent
    assert not {"spmm_weighted_roofline", "spmm_int8_roofline"} & set(got)
