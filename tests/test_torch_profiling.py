"""glnn_tpu_torch.utils.profiling.trace and utils/trace_report: a CPU trace
of a plain op, the refusal to trace CUDA without a GPU, the demangled names
of the port's kernels, and the report's arithmetic over a hand-written
Chrome trace (counts, totals, busy time as a union, window, idle share).
The program's spans (`profiling.span`): silent and one flag read without a
profiler; under one, a GAT epoch's spans with their parents and roots, in
the Chrome trace too; each kernel wrapper's span; self time; the bound."""

import collections
import gzip
import json
import logging

import numpy as np
import pytest
import torch

from glnn_tpu_torch import ops
from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.nn.models import Model
from glnn_tpu_torch.ops import gat_cuda, refops, spmm_cuda
from glnn_tpu_torch.train import engine
from glnn_tpu_torch.train.state import make_adam
from glnn_tpu_torch.utils import profiling, trace_report
from glnn_tpu_torch.utils.trace_report import ITER_SPAN, port_name, report

# the kernels' demangled names as the H100's trace gives them
_SPMM = ("void (anonymous namespace)::spmm_csr_kernel<(anonymous namespace)::"
         "{p}, {v}, false, (anonymous namespace)::{h}>(int const*, int "
         "const*, (anonymous namespace)::{p}::TIn const*, (anonymous "
         "namespace)::{p}, (anonymous namespace)::{h}, float*, int2 const*, "
         "(anonymous namespace)::{p}::TAcc*, int, int, int, int, int, int)")
_SPMM_COMBINE = ("void (anonymous namespace)::spmm_csr_combine_kernel<"
                 "(anonymous namespace)::{p}, (anonymous namespace)::{h}>("
                 "int const*, int const*, (anonymous namespace)::{p}::TAcc "
                 "const*, (anonymous namespace)::{p}, (anonymous namespace)::"
                 "{h}, float*, int, int)")
DEMANGLED = {
    "spmm_csr_bf16": _SPMM.format(p="Sum<__nv_bfloat16, float>", v=8,
                                  h="NoHop"),
    "spmm_csr_int8": _SPMM.format(p="Sum<signed char, int>", v=8,
                                  h="NoHop"),
    "spmm_csr_weighted": _SPMM.format(p="Weighted", v=4, h="NoHop"),
    "spmm_csr_f32": "void (anonymous namespace)::spmm_f32_kernel<4>(int "
                    "const*, int const*, float const*, int2 const*, float*, "
                    "float*, int, int, int, int, int, int)",
    "gat_prep": "void (anonymous namespace)::gat_prep_kernel<4, 1>(float "
                "const*, float const*, float const*, __nv_bfloat16*, float*, "
                "__nv_bfloat16*, long, int, int, int)",
    "gat_fwd": "void (anonymous namespace)::gat_fwd_kernel<8, 1, 8, false>("
               "int const*, int const*, __nv_bfloat16 const*, float const*, "
               "__nv_bfloat16 const*, (anonymous namespace)::DropArgs, float, "
               "float*, float*, float*, (anonymous namespace)::HubArgs, int, "
               "int, int, int, int, int)",
    "gat_bwd": "void (anonymous namespace)::gat_bwd_kernel<8, 1>(int const*, "
               "int const*, __nv_bfloat16 const*, float const*, __nv_bfloat16 "
               "const*, (anonymous namespace)::DropArgs, float, float const*)",
    "edge_softmax_fwd": "(anonymous namespace)::edge_softmax_fwd_kernel(int "
                        "const*, float const*, float*, int, int, int, int)",
    "edge_softmax_bwd": "void (anonymous namespace)::edge_softmax_bwd_kernel"
                        "<false>(int const*, float const*, float const*, "
                        "float*, (anonymous namespace)::BwdHub, int, int, "
                        "int)",
}
TORCH_KERNEL = ("void at::native::vectorized_elementwise_kernel<8, "
                "at::native::bfloat16_copy_kernel_cuda("
                "at::TensorIteratorBase&)::{lambda(float)#1}, "
                "std::array<char*, 2ul> >(int)")


@pytest.mark.parametrize("port", sorted(DEMANGLED))
def test_port_name_of_each_kernel(port):
    assert port_name(DEMANGLED[port]) == port


# APPNP's fused hops (forward, transposed, int8 eval: Appnp<0>, <1>, <2>),
# walk and combine, count under their policy's kernel
FUSED_HOPS = [(form.format(p=p, v=v, h=f"Appnp<{i}>").replace(">>", "> >"),
               port)
              for form in (_SPMM, _SPMM_COMBINE)
              for p, v, i, port in (("Weighted", 4, 0, "spmm_csr_weighted"),
                                    ("Weighted", 4, 1, "spmm_csr_weighted"),
                                    ("Sum<signed char, int>", 8, 2,
                                     "spmm_csr_int8"))]


@pytest.mark.parametrize("name,port", FUSED_HOPS)
def test_port_name_of_each_fused_hop_kernel(name, port):
    assert port_name(name) == port


# the f32 sum's second pass, counted as a launch of spmm_csr_f32 as well
F32_COMBINE = ("(anonymous namespace)::spmm_f32_combine_kernel(int const*, "
               "int const*, float const*, float*, int, int)")


def test_port_name_of_the_f32_second_pass():
    assert port_name(F32_COMBINE) == "spmm_csr_f32"


# the passes of split hub rows, each counted as a launch of its kernel
HUB_PASSES = {
    "spmm_csr_bf16": "void (anonymous namespace)::spmm_csr_combine_kernel<"
                     "(anonymous namespace)::Sum<__nv_bfloat16, float> >(int "
                     "const*, int const*, float const*, (anonymous namespace)"
                     "::Sum<__nv_bfloat16, float>, float*, int, int)",
    "spmm_csr_int8": "void (anonymous namespace)::spmm_csr_combine_kernel<"
                     "(anonymous namespace)::Sum<signed char, int> >(int "
                     "const*, int const*, int const*, (anonymous namespace)"
                     "::Sum<signed char, int>, float*, int, int)",
    "spmm_csr_weighted": "void (anonymous namespace)::spmm_csr_combine_kernel"
                         "<(anonymous namespace)::Weighted>(int const*, int "
                         "const*, float const*, (anonymous namespace)::"
                         "Weighted, float*, int, int)",
    "gat_fwd": "(anonymous namespace)::gat_fwd_max_kernel((anonymous "
               "namespace)::HubArgs, int const*, float const*, __nv_bfloat16 "
               "const*, float, int)",
    "gat_fwd ": "(anonymous namespace)::gat_fwd_combine_kernel((anonymous "
                "namespace)::HubArgs, float*, float*, float*, int, int, int)",
    "gat_bwd": "void (anonymous namespace)::gat_bwd_kernel<8, 1, (anonymous "
               "namespace)::BwdItems)1>(int const*, int const*, "
               "__nv_bfloat16 const*, float const*, __nv_bfloat16 const*, "
               "(anonymous namespace)::DropArgs, float, float const*)",
    "gat_bwd ": "(anonymous namespace)::gat_bwd_combine_kernel((anonymous "
                "namespace)::BwdHub, float*, int, int)",
    "edge_softmax_fwd": "(anonymous namespace)::edge_softmax_hub_max_kernel("
                        "(anonymous namespace)::HubArgs, float const*, int, "
                        "int)",
    "edge_softmax_fwd ": "(anonymous namespace)::edge_softmax_hub_sum_kernel("
                         "(anonymous namespace)::HubArgs, float const*, int, "
                         "int)",
    "edge_softmax_fwd  ": "void (anonymous namespace)::edge_softmax_fwd_kernel"
                          "<true>(int const*, float const*, float*, "
                          "(anonymous namespace)::HubArgs, int, int, int, "
                          "int)",
    "edge_softmax_bwd": "(anonymous namespace)::edge_softmax_bwd_hub_t_kernel("
                        "(anonymous namespace)::BwdHub, float const*, float "
                        "const*, int, int)",
    "edge_softmax_bwd ": "void (anonymous namespace)::edge_softmax_bwd_kernel"
                         "<true>(int const*, float const*, float const*, "
                         "float*, (anonymous namespace)::BwdHub, int, int, "
                         "int)",
}


@pytest.mark.parametrize("port", sorted(HUB_PASSES))
def test_port_name_of_the_hub_passes(port):
    assert port_name(HUB_PASSES[port]) == port.strip()


KEPT = [TORCH_KERNEL, "Memcpy HtoD (Pageable -> Device)", "aten::index_add_"]


@pytest.mark.parametrize("name", KEPT)
def test_port_name_keeps_other_names(name):
    assert port_name(name) == name


# gnnbench/trace.py keeps a copy of the kernel-name map (the benchmark is
# added to, never edited): each name above comes out as the same kernel
# of both maps, and a kept name as none of them
ALL_NAMES = ([(DEMANGLED[p], p) for p in sorted(DEMANGLED)] + FUSED_HOPS
             + [(F32_COMBINE, "spmm_csr_f32")]
             + [(HUB_PASSES[p], p.strip()) for p in sorted(HUB_PASSES)]
             + [(name, None) for name in KEPT])


@pytest.mark.parametrize("name,port", ALL_NAMES,
                         ids=[port or "kept" for _, port in ALL_NAMES])
def test_port_name_agrees_with_the_benchmark_s_copy(name, port):
    from gnnbench import trace as bench_trace

    kernels = {k for _, k in trace_report.PORT_KERNELS}
    assert kernels == {k for _, k in bench_trace.PORT_KERNELS}
    if port is None:
        assert bench_trace.port_name(name) not in kernels
    else:
        assert bench_trace.port_name(name) == port_name(name) == port


def test_cpu_trace_of_copy_u_sum(tmp_path):
    rs = np.random.RandomState(0)
    g = build_graph(rs.randint(0, 50, 400), rs.randint(0, 50, 400), 50)
    x = torch.randn((50, 8))
    with profiling.trace(tmp_path, torch.device("cpu")) as t:
        refops.copy_u_sum(g, x)
    assert t.path.exists() and t.path.parent == tmp_path
    res = report(tmp_path, quiet=True)           # the newest under the dir
    assert res["path"] == str(t.path) and res["device"] == "cpu"
    rows = {r.name: r for r in res["rows"]}
    assert rows["aten::index_add_"].count == 1
    assert 0.0 < res["busy_ms"] <= res["window_ms"]


def test_trace_and_report_on_cpu_counts_the_traced_calls(tmp_path):
    rs = np.random.RandomState(1)
    g = build_graph(rs.randint(0, 30, 200), rs.randint(0, 30, 200), 30)
    x = torch.randn((30, 4))
    calls = []

    def run():
        calls.append(1)
        refops.copy_u_sum(g, x)

    res = trace_report.trace_and_report(run, torch.device("cpu"), iters=3,
                                        out_dir=tmp_path, quiet=True)
    assert len(calls) == 4                      # one warm call, then 3
    row = {r.name: r for r in res["rows"]}["aten::index_add_"]
    assert row.count == 3 and row.ms_per_iter == pytest.approx(
        row.total_ms / 3)
    assert 0.0 <= res["idle_share"] < 1.0


def test_trace_on_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(tmp_path, torch.device("cuda:0")):
            pass
    assert not list(tmp_path.iterdir())


def _x(name, cat, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, pid=1, tid=7, ts=ts, dur=dur,
                **kw)


def _device_trace():
    """Two traced calls, [1000, 1100] and [1150, 1260] us; kernels that
    overlap, a gap, a memcpy, a memset and a kernel of torch's own; host
    ops and annotations that the device report must leave out."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
        _x(ITER_SPAN, "user_annotation", 1000, 100),
        _x(ITER_SPAN, "user_annotation", 1150, 110),
        _x(ITER_SPAN, "gpu_user_annotation", 1005, 250),
        _x("aten::index_add_", "cpu_op", 1001, 90),
        _x("cudaLaunchKernel", "cuda_runtime", 1002, 5),
        _x("PyTorch Profiler (0)", "Trace", 900, 500),
        _x(DEMANGLED["spmm_csr_bf16"], "kernel", 1010, 20),
        _x(DEMANGLED["spmm_csr_int8"], "kernel", 1020, 20),     # overlaps
        _x(DEMANGLED["gat_fwd"], "kernel", 1050, 10),
        _x(DEMANGLED["spmm_csr_bf16"], "kernel", 1155, 3),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1160, 10),
        _x("Memset (Device)", "gpu_memset", 1200, 5),
        _x(TORCH_KERNEL, "kernel", 1210, 40),
    ]
    return {"deviceProperties": [{"id": 0}], "traceEvents": ev}


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
@pytest.mark.parametrize("by_dir", [False, True])
def test_report_over_a_written_device_trace(tmp_path, suffix, by_dir):
    path = tmp_path / f"t.pt.trace{suffix}"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(_device_trace(), f)
    res = report(tmp_path if by_dir else path, iters=2, quiet=True)
    assert res["device"] == "cuda" and res["path"] == str(path)
    rows = {r.name: (r.count, r.total_ms, r.ms_per_iter) for r in res["rows"]}
    want = {"spmm_csr_bf16": (2, 0.023), "spmm_csr_int8": (1, 0.020),
            "gat_fwd": (1, 0.010), TORCH_KERNEL: (1, 0.040),
            "Memcpy DtoH (Device -> Pageable)": (1, 0.010),
            "Memset (Device)": (1, 0.005)}
    assert set(rows) == set(want)
    for name, (count, total) in want.items():
        assert rows[name][0] == count
        assert rows[name][1] == pytest.approx(total)
        assert rows[name][2] == pytest.approx(total / 2)
    assert [r.name for r in res["rows"]][:2] == [TORCH_KERNEL,
                                                 "spmm_csr_bf16"]
    # union: [1010, 1040] + [1050, 1060] + [1155, 1158] + [1160, 1170]
    # + [1200, 1205] + [1210, 1250] = 98 us of the 260 us window
    assert res["busy_ms"] == pytest.approx(0.098)
    assert res["window_ms"] == pytest.approx(0.260)
    assert res["idle_share"] == pytest.approx(1 - 98 / 260)
    assert res["total_ms_per_iter"] == pytest.approx(0.108 / 2)


def test_report_of_a_cpu_trace_takes_the_host_ops(tmp_path):
    ev = [_x("aten::mm", "cpu_op", 0, 40), _x("aten::add", "cpu_op", 30, 20),
          _x("aten::mm", "cpu_op", 100, 10)]
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"deviceProperties": [], "traceEvents": ev}))
    res = report(path, quiet=True)
    assert res["device"] == "cpu"
    assert [(r.name, r.count) for r in res["rows"]] == [("aten::mm", 2),
                                                        ("aten::add", 1)]
    assert res["busy_ms"] == pytest.approx(0.060)
    assert res["window_ms"] == pytest.approx(0.110)


def test_report_finds_no_trace(tmp_path):
    with pytest.raises(FileNotFoundError, match="no Chrome trace"):
        report(tmp_path, quiet=True)


# ---- the program's spans ----------------------------------------------------

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture()
def spans(monkeypatch):
    """A fresh span log, emptied again after the test."""
    monkeypatch.setattr(profiling, "_log", profiling.SpanLog())
    return profiling._log


def test_span_without_a_profiler_reads_one_flag_and_records_nothing(
        spans, monkeypatch):
    reads = []

    def flag():
        reads.append(1)
        return False

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(profiling, "_profiler_enabled", flag)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s = profiling.span("runner.eval")
    with s:
        pass
    assert reads == [1]
    assert profiling.span_records() == [] and profiling.span_totals() == {}
    assert spans.dropped == 0


def _gat_epoch_parts(n=60, e=400, seed=0):
    """A tiny full-batch GAT teacher on the kernel tier's plain versions:
    the runner's epoch, its eval and its metrics row, as a CLI epoch with
    eval_interval 1 runs them."""
    rs = np.random.RandomState(seed)
    g = build_graph(rs.randint(0, n, e), rs.randint(0, n, e), n)
    torch.manual_seed(seed)
    conf = {"model_name": "GAT", "num_layers": 2, "hidden_dim": 16,
            "feat_dim": 8, "label_dim": 3, "dropout_ratio": 0.5,
            "num_heads": 2, "attn_dropout_ratio": 0.3}
    model = Model(conf)
    opt = make_adam(model.parameters(), 0.01, 0.0)
    feats = torch.randn(n, 8)
    labels = torch.from_numpy(rs.randint(0, 3, n))
    idx = [torch.arange(0, 20), torch.arange(20, 40), torch.arange(40, n)]
    gen = torch.Generator().manual_seed(seed)
    train = engine._teacher_epoch_fn(conf, model, opt, logging.getLogger(),
                                     g, feats, labels, idx[0], gen)
    evaluate = engine.make_eval_fn(model)

    def epoch(i):
        train(i)
        out = evaluate(g, feats)
        engine._metrics_row((out, labels, ix) for ix in idx)
    return epoch


# each span of the epoch, with the span around it (None: a root)
EPOCH_PARENTS = {
    "runner.train_epoch": None,
    "runner.forward": "runner.train_epoch",
    "runner.backward": "runner.train_epoch",
    "runner.optimizer": "runner.train_epoch",
    "model.GAT.layer0": {"runner.forward", "runner.eval"},
    "model.GAT.layer1": {"runner.forward", "runner.eval"},
    "kernel.gat_prep": {"model.GAT.layer0", "model.GAT.layer1"},
    "kernel.gat_fwd": {"model.GAT.layer0", "model.GAT.layer1"},
    "kernel.gat_bwd": "runner.backward",
    "kernel.spmm_csr_bf16": "runner.backward",
    "runner.eval": None,
    "runner.metrics_row": None,
    "runner.host_read": {"runner.train_epoch", "runner.metrics_row"},
}


def test_gat_epoch_records_the_spans_with_parents_and_roots(spans,
                                                            monkeypatch):
    monkeypatch.setattr(ops, "_tier_selected", lambda device: True)
    epoch = _gat_epoch_parts()
    epoch(1)                          # builds the hub plans
    assert profiling.span_records() == []
    with torch.profiler.profile(activities=CPU):
        epoch(2)
        epoch(3)
    recs = profiling.span_records()
    by_id = {r.id: r for r in recs}
    assert {r.name for r in recs} == set(EPOCH_PARENTS)
    for r in recs:
        assert r.end_ns >= r.start_ns > 0
        want = EPOCH_PARENTS[r.name]
        if want is None:
            assert r.parent == -1 and r.root == r.id, r
            continue
        parent = by_id[r.parent]
        assert parent.name in ({want} if isinstance(want, str) else want), r
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
        assert r.root == parent.root and r.thread == parent.thread
    roots = collections.Counter(by_id[r.root].name for r in recs
                                if r.parent == -1)
    assert roots == {"runner.train_epoch": 2, "runner.eval": 2,
                     "runner.metrics_row": 2}
    # two train-step layers and two eval layers an epoch, each one
    # gat_prep and one gat_fwd; a source reduce per backward layer
    calls = {k: v[0] for k, v in profiling.span_totals().items()}
    assert calls["kernel.gat_fwd"] == calls["kernel.gat_prep"] == 8
    assert calls["kernel.gat_bwd"] == calls["kernel.spmm_csr_bf16"] == 4


def test_host_reads_are_seven_an_epoch(spans):
    epoch = _gat_epoch_parts()
    epoch(1)
    with torch.profiler.profile(activities=CPU):
        for i in range(3):
            epoch(2 + i)
    calls, total, own = profiling.span_totals()["runner.host_read"]
    assert calls == 3 * 7                      # the loss and six metrics
    assert 0.0 < own == pytest.approx(total)   # no span inside a read


def test_spans_are_user_annotations_in_the_chrome_trace(spans, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(ops, "_tier_selected", lambda device: True)
    epoch = _gat_epoch_parts()
    epoch(1)
    with profiling.trace(tmp_path, torch.device("cpu")) as t:
        epoch(2)
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation")
    totals = profiling.span_totals()
    assert set(EPOCH_PARENTS) <= set(names)
    for name in EPOCH_PARENTS:
        assert names[name] == totals[name][0], name


def _wrapper_calls():
    """One call of each kernel wrapper on CPU tensors (its plain version),
    by the span it records."""
    rs = np.random.RandomState(3)
    n, h, d = 40, 2, 8
    g = build_graph(rs.randint(0, n, 300), rs.randint(0, n, 300), n)
    e = g.n_edges
    feat = torch.randn(n, h, d)
    al, ar = torch.randn(h, d), torch.randn(h, d)
    x = torch.randn(n, 16)
    alpha = torch.rand(e, h)

    def fwd():
        fb, el, erb, _ = gat_cuda.prep(feat, al, ar)
        return fb, el, erb, gat_cuda.gat_fwd(g.indptr, g.senders, fb, el, erb)

    def bwd():
        fb, el, erb, (_, smax, den) = fwd()
        return gat_cuda.gat_bwd(g.indptr, g.senders, fb, el, erb, None, 1.0,
                                0.2, smax, den, torch.randn(n, h, d),
                                al.to(torch.bfloat16))

    q, scale = spmm_cuda.quantize_cols(x)
    return {
        "kernel.gat_prep": lambda: gat_cuda.prep(feat, al, ar),
        "kernel.gat_fwd": fwd,
        "kernel.gat_bwd": bwd,
        "kernel.edge_softmax_fwd": lambda: gat_cuda.edge_softmax_fwd(
            g.indptr, alpha, n),
        "kernel.edge_softmax_bwd": lambda: gat_cuda.edge_softmax_bwd(
            g.indptr, alpha, torch.rand(e, h), n),
        "kernel.spmm_csr_bf16": lambda: spmm_cuda.csr_sum_bf16(
            g.indptr, g.senders, x.to(torch.bfloat16), n),
        "kernel.spmm_csr_int8": lambda: spmm_cuda.csr_sum_int8(
            g.indptr, g.senders, q, scale, n),
        "kernel.spmm_csr_weighted": lambda: spmm_cuda.csr_wsum_bf16(
            g.indptr, g.senders, None, x, torch.rand(e), n),
        "kernel.spmm_csr_f32": lambda: spmm_cuda.csr_sum_f32(
            g.indptr, g.senders, x, n),
        "plan.hub_plan": lambda: spmm_cuda.hub_plan(g.indptr, n, 4),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_each_kernel_wrapper_records_its_span(spans, name):
    call = _wrapper_calls()[name]
    call()
    assert profiling.span_records() == []
    with torch.profiler.profile(activities=CPU):
        call()
    totals = profiling.span_totals()
    assert totals[name][0] == 1
    assert {r.name.split(".")[0] for r in profiling.span_records()} <= {
        "kernel", "plan"}
    counts_name = name.split(".", 1)[1]
    assert counts_name in {**gat_cuda.counts, **spmm_cuda.counts,
                           **spmm_cuda.builds}


def test_span_totals_subtract_children_on_the_same_thread(spans):
    R = profiling.SpanRecord
    ms = 1_000_000
    spans.records[:] = [
        R("runner.train_epoch", 0, 10 * ms, -1, 0, 1, 0),
        R("runner.forward", 1 * ms, 4 * ms, 0, 0, 1, 1),
        R("model.GAT.layer0", 1 * ms, 2 * ms, 1, 0, 1, 2),
        R("model.GAT.layer1", 2 * ms, 4 * ms, 1, 0, 1, 3),
        R("runner.backward", 5 * ms, 9 * ms, 0, 0, 1, 4),
        # autograd's thread: the root of the call, no parent of its own
        R("kernel.gat_bwd", 6 * ms, 8 * ms, -1, 0, 2, 5),
        R("runner.eval", 20 * ms, 23 * ms, -1, 6, 1, 6),
        R("model.GAT.layer0", 21 * ms, 22 * ms, 6, 6, 1, 7),
        R("runner.host_read", 30 * ms, 0, -1, 8, 1, 8),      # still open
    ]
    assert profiling.span_totals() == {
        "runner.train_epoch": (1, 10.0, 3.0),
        "runner.forward": (1, 3.0, 0.0),
        "model.GAT.layer0": (2, 2.0, 2.0),
        "model.GAT.layer1": (1, 2.0, 2.0),
        "runner.backward": (1, 4.0, 4.0),
        "kernel.gat_bwd": (1, 2.0, 2.0),
        "runner.eval": (1, 3.0, 2.0),
    }
    profiling.clear_spans()
    assert profiling.span_records() == [] and profiling.span_totals() == {}


def test_a_span_on_another_thread_takes_the_open_call_s_root(
        spans, monkeypatch):
    """As autograd's device thread runs a backward's kernel spans while
    the caller waits in `loss.backward()` (autograd hands that thread the
    caller's profiler state; a plain thread has none, so the flag is
    forced here)."""
    import threading

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    outer, inner = profiling.span("runner.backward"), profiling.span(
        "kernel.gat_bwd")

    def device_thread():
        with inner:
            pass

    with outer:
        t = threading.Thread(target=device_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    with inner:                       # a call of its own afterwards
        pass
    a, b, c = profiling.span_records()
    assert (a.name, b.name, c.name) == ("runner.backward", "kernel.gat_bwd",
                                        "kernel.gat_bwd")
    assert b.thread != a.thread and b.parent == -1 and b.root == a.id
    assert c.parent == -1 and c.root == c.id


def test_the_record_bound_drops_and_counts(monkeypatch):
    log = profiling.SpanLog(cap=5)
    monkeypatch.setattr(profiling, "_log", log)
    s = profiling.span("runner.host_read")
    with torch.profiler.profile(activities=CPU):
        for _ in range(8):
            with s:
                pass
    assert len(log.records) == 5 and profiling.spans_dropped() == 3
    assert profiling.span_totals()["runner.host_read"][0] == 5
    profiling.clear_spans()
    assert profiling.spans_dropped() == 0
