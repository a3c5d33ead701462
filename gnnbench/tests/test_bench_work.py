"""The yardstick's arithmetic on small hand-worked cases: bytes, FLOPs,
rooflines, idle shares, mfu, and the trace reduction."""

import pytest

from gnnbench import readers, work
from gnnbench.trace import ITER, port_name, reduce

GAT = work.model_work("GAT")


def test_op_counts_by_hand():
    # 2 rows, 3 edges, 1 head of 2: indptr 3 x 4 B, senders 3 x 4, bf16
    # features 2 x 2 x 2, el f32 2 x 4, er bf16 2 x 2; out f32 2 x 2 x 4,
    # max and denominator 2 x 2 x 4
    b, f = GAT.fwd_op(2, 3, 1, 2)
    assert b == 12 + 12 + 8 + 8 + 4 + 16 + 16 and f == 3 * (8 + 4)
    b, f = GAT.bwd_op(1, 1, 1, 1)
    assert b == 8 + 4 + 2 + 4 + 2 + 8 + 4 + 2 + 4 + 2 + 4
    assert f == 12 + 8


def test_model_work_is_found_by_name():
    assert work.model_work("GAT") is GAT
    with pytest.raises(ValueError, match="no model file for 'GCN'"):
        work.model_work("GCN")
    recipe = {"num_layers": 2, "hidden_dim": 4, "num_heads": 2}
    ds = {"n_nodes": 3, "n_feats": 5, "n_classes": 6}
    ops = GAT.epoch_ops(recipe, ds, 7)
    # two layers: (5 -> 2 heads of 2), (4 -> 1 head of 6); gat_fwd in the
    # step and in the eval, gat_bwd in the step
    assert ops["gat_fwd"] == [GAT.fwd_op(3, 7, 2, 2), GAT.fwd_op(3, 7, 1, 6)] * 2
    assert ops["gat_bwd"] == [GAT.bwd_op(3, 7, 2, 2), GAT.bwd_op(3, 7, 1, 6)]


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_model_flops_by_hand():
    # one layer, one head of 2 over 3 features, 4 nodes, 5 edges: forward
    # product 2*4*3*2 = 48, score vectors 4*4*2 = 32, edges 5*(8 + 4) = 60;
    # backward product 48, edges 5*(12 + 16) = 140, source sum 5*2 = 10,
    # score vectors 32 (no input gradient at layer 0)
    gat = {"num_layers": 1, "hidden_dim": 2, "num_heads": 1}
    fwd = 48 + 32 + 60
    assert GAT.step_flops(gat, 3, 2, 4, 5, train=False) == fwd
    assert GAT.step_flops(gat, 3, 2, 4, 5) == fwd + 48 + 140 + 10 + 32
    ds = {"n_nodes": 4, "n_feats": 3, "n_classes": 2}
    assert GAT.epoch_flops(gat, ds, 5) == 2 * fwd + 48 + 140 + 10 + 32


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduce_busy_gaps_and_names():
    events = [
        _ev(ITER, "user_annotation", 0, 100),
        _ev("void (anonymous namespace)::gat_fwd_kernel<8, 2>(int)", "kernel",
            10, 20),
        _ev("void gat_fwd_combine_kernel(int)", "kernel", 25, 15),
        _ev("ampere_sgemm", "kernel", 60, 10),
        _ev("aten::mm", "cpu_op", 40, 25),
        _ev("cudaStreamSynchronize", "cuda_runtime", 70, 30),
    ]
    r = reduce(events)
    assert r["busy_s"] == pytest.approx(40e-6)         # [10, 40] + [60, 70]
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["ops"]["gat_fwd"] == pytest.approx(35e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(20e-6)     # [40, 60]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["(no host op)"] == pytest.approx(10e-6)  # [0, 10]
    assert port_name("spmm_csr_kernel<(anonymous namespace)::Sum<signed "
                     "char, int>, 8>") == "spmm_csr_int8"


def test_readers_arithmetic_and_silence():
    trace = {"busy_s": 0.25, "window_s": 1.0, "ops": {"gat_fwd": 2e-3}}
    ctx = {"loop": "teacher_epochs", "role": "train", "trace": trace,
           "spans": {"train": [0.1, 0.3]},
           "ops": {"gat_fwd": [(3.35e9, 0.0)]}, "calls": 1,
           "flops": 67e12, "elapsed_s": 2.0, "dtype": "float32"}
    assert readers.idle_share(ctx, "train") == pytest.approx(75.0)
    assert readers.idle_share(ctx, "serve") is None
    assert readers.device_ms(ctx, "train") == pytest.approx(250.0)
    assert readers.device_ms(ctx, "serve") is None
    assert readers.roofline(ctx, "gat_fwd") == pytest.approx(50.0)
    assert readers.roofline(ctx, "gat_bwd") is None
    assert readers.mfu(ctx, "train") == pytest.approx(50.0)
    assert readers.mean_ms(ctx, "teacher_epochs", "train") == \
        pytest.approx(200.0)
    assert readers.mean_ms(ctx, "serve_closed", "eval") is None
