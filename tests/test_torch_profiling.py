"""glnn_tpu_torch.utils.profiling.trace and utils/trace_report: a CPU trace
of a plain op, the refusal to trace CUDA without a GPU, the demangled names
of the port's kernels, and the report's arithmetic over a hand-written
Chrome trace (counts, totals, busy time as a union, window, idle share)."""

import gzip
import json

import numpy as np
import pytest
import torch

from glnn_tpu_torch.graph.container import build_graph
from glnn_tpu_torch.ops import refops
from glnn_tpu_torch.utils import profiling, trace_report
from glnn_tpu_torch.utils.trace_report import ITER_SPAN, port_name, report

# the kernels' demangled names as the H100's trace gives them
_SPMM = ("void (anonymous namespace)::spmm_csr_kernel<(anonymous namespace)::"
         "{p}, {v}, false>(int const*, int const*, (anonymous namespace)::"
         "{p}::TIn const*, (anonymous namespace)::{p}, float*, int2 const*, "
         "(anonymous namespace)::{p}::TAcc*, int, int, int, int, int, int)")
DEMANGLED = {
    "spmm_csr_bf16": _SPMM.format(p="Sum<__nv_bfloat16, float>", v=8),
    "spmm_csr_int8": _SPMM.format(p="Sum<signed char, int>", v=8),
    "spmm_csr_weighted": _SPMM.format(p="Weighted", v=4),
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


@pytest.mark.parametrize("name", [TORCH_KERNEL, "Memcpy HtoD (Pageable -> "
                                  "Device)", "aten::index_add_"])
def test_port_name_keeps_other_names(name):
    assert port_name(name) == name


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
