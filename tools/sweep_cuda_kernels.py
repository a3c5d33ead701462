#!/usr/bin/env python3
"""Time variants of the port's redesigned CUDA kernels on one GPU.

    python3 tools/sweep_cuda_kernels.py [--out PATH]   # from the repository root

Each variant is the source in glnn_tpu_torch/csrc with one thing changed
in a copy: the minimum resident blocks per SM asked of ptxas
(__launch_bounds__) for the CSR SpMM body (spmm_csr.cu), for gat_fwd or
for gat_bwd (gat_csr.cu), which caps the registers a thread may use; the
scores per lane R of edge_softmax_fwd (kSoftmaxRegs); gat_fwd with one
stage cut out, to split its time (`gat_fwd_parts`: "scores only" reads no
feature row, "features only" loads no el, takes no max, forms every term
as 1 and draws the keep bits from a multiplicative hash at the same keep
rate, with no Philox); or the f32 sum (spmm_f32.cu, `f32`) with another
ring depth S (kStages), chunk length T (kChunkEdges) or set of L2 hints H
(kCacheHints), and "template":
spmm_csr.cu with an entry point that instantiates its body for f32 rows
(Sum<float, float>, the f32 sum's earlier form) at `spmm_cuda.geometry`'s
layout, timed beside the others in the same run; or, with the sources as
they are, the chunk length T of the hub plan (a launch argument, so no
rebuild) that splits hub rows across warps in the template body
(`spmm_hub`), in gat_fwd (`gat_fwd_hub`), in gat_bwd (`gat_bwd_hub`), in
edge_softmax_fwd (`softmax_hub`) and in edge_softmax_bwd
(`softmax_bwd_hub`). Every variant is built
with the port's nvcc flags
into a temporary directory, loaded in place of the port's library,
checked against the plain version (the cut gat_fwd variants are only
timed), and timed with CUDA events on the synth-n169343-c40-f128-d7
graph at the main paths' widths:
- the exact and int8 sums at F = 40, 64, 128, 256, the weighted sum at
  F = 40 (forward and transposed walk) and per head at (8, 16), each under
  every lane layout the kernel takes;
- gat_fwd at (8, 16) and (1, 40), dropout in seed mode, under every lane
  layout it takes (each load width, with all slots or one), with the
  grid that fills every SM once and with one warp per row;
- gat_fwd's cut variants at both shapes in seed mode, the port's layout;
- gat_bwd at both shapes in seed mode; gat_prep at both shapes;
- edge_softmax_fwd at [E, 1] and [E, 8] with R = 1, 2, 4, 8 scores per
  lane (and the edge slots per row that R implies);
- the f32 sum at F = 100 and 128, on the synth graph and on chip_smoke's
  hub graph (rows of up to 20,000 edges), each S, T and H variant under
  F32_COPIES = 1, 2, 4, 8 copies per lane per stage (the edges a stage
  holds), checked against the plain version (1e-5 of each row's
  magnitude) and for two launches bit-equal, eager and device time;
- `spmm_hub`: the exact, int8 and weighted sums at F = 40 and 128, and
  `gat_fwd_hub`: gat_fwd at both GAT shapes in seed mode, on the synth
  and the hub graph, with hub plans cut at T = 128, 256, 512 and 1,024
  edges,
  at T = 64 edges per edge group (64 steps of a chunk's warp whatever
  the layout; gat_fwd: 64 per edge slot) and unsplit (one warp per row,
  what the split replaces), each held to the plain version (int8 exactly) and
  for two launches bit-equal, eager and device time;
- `gat_bwd_hub`: gat_bwd at both GAT shapes in seed mode with T = 128,
  256 and 512 and unsplit (with gat_fwd_hub, the sweep that picks the GAT
  layer's T, gat_cuda.GAT_CHUNK), `softmax_hub`: edge_softmax_fwd on
  [E, 1] and [E, 8] scores with T = 128, 256 and 512 and unsplit, and
  `softmax_bwd_hub`: edge_softmax_bwd on the same scores' alpha with the
  same T, on the synth and the hub graph, held and timed alike.
The lane layouts, grids and plans are launch arguments, so they need no
rebuild. Prints each variant's ptxas registers, stack frame and spill
stores per instantiation of the swept kernel and its times, and writes
them all to PATH as JSON (by default build/sweep_cuda_kernels.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from glnn_tpu_torch.graph.datasets import load_synth_data  # noqa: E402
from glnn_tpu_torch.ops import (cuda_build, gat_cuda, refops,  # noqa: E402
                                spmm_cuda)

_port_geometry = spmm_cuda.geometry
_port_fwd_geometry = gat_cuda.fwd_geometry
_port_blocks = gat_cuda._blocks

# each kernel's variants; None: the source as it is. spmm, gat_fwd,
# gat_bwd: the minimum blocks per SM (0: no minimum); softmax: R;
# gat_fwd_parts: the stage left in (None: the whole kernel, timed alike)
VARIANTS = {"spmm": [None, 6, 0], "gat_fwd": [None, 0, 6], "gat_bwd": [None],
            "softmax": [None, 1, 2, 4],
            "gat_fwd_parts": [None, "scores only", "features only"],
            "f32": [None, "S=1", "S=3", "S=4", "T=128", "T=256", "T=1024",
                    "H=0", "template"],
            "spmm_hub": [None], "gat_fwd_hub": [None], "gat_bwd_hub": [None],
            "softmax_hub": [None], "softmax_bwd_hub": [None]}
KERNEL = {"spmm": "spmm_csr_kernel", "gat_fwd": "gat_fwd_kernel",
          "gat_bwd": "gat_bwd_kernel", "softmax": "edge_softmax_fwd_kernel",
          "gat_fwd_parts": "gat_fwd_kernel", "f32": "spmm_f32_kernel",
          "spmm_hub": "spmm_csr_kernel", "gat_fwd_hub": "gat_fwd_kernel",
          "gat_bwd_hub": "gat_bwd_kernel",
          "softmax_hub": "edge_softmax_fwd_kernel",
          "softmax_bwd_hub": "edge_softmax_bwd_kernel"}
LIBRARY = {"spmm": "spmm", "gat_fwd": "gat", "gat_bwd": "gat",
           "softmax": "gat", "gat_fwd_parts": "gat", "f32": "spmm_f32",
           "spmm_hub": "spmm", "gat_fwd_hub": "gat", "gat_bwd_hub": "gat",
           "softmax_hub": "gat", "softmax_bwd_hub": "gat"}
# the hub sweeps' chunk lengths: edges, "64G" (64 per edge group or slot)
# and None, unsplit (a T no row exceeds)
HUB_CHUNKS = (256, 512, 1024, "64G", None)
GAT_FWD_CHUNKS = (128,) + HUB_CHUNKS
GAT_BWD_CHUNKS = (128, 256, 512, None)
SOFTMAX_CHUNKS = (128, 256, 512, None)
F32_WIDTHS = (100, 128)
F32_COPIES = (1, 2, 4, 8)
# the template body's entry point for f32 rows, appended to spmm_csr.cu
_TEMPLATE_F32 = """
extern "C" int spmm_csr_template_f32(const void* indptr, const void* indices,
    const void* x, void* out, int n_rows, int f, int vec, int lanes,
    int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr),
                static_cast<const int32_t*>(indices),
                static_cast<const float*>(x), Sum<float, float>{nullptr},
                static_cast<float*>(out), nullptr, nullptr, n_rows, 0,
                1 << 30, f, vec, lanes, groups,
                static_cast<cudaStream_t>(stream));
}
"""
WIDTHS = (40, 64, 128, 256)
# gat_fwd's keep bits in "features only": 8 heads' bits of edge e from
# (e + 1) * 2654435761 * (2 i + 1) < thresh, about the seed mode's share
_HASH_BITS = """{
          const unsigned x = (static_cast<unsigned>(e0 + lane) + 1u) * 2654435761u;
          unsigned b = 0;
          for (int i = 0; i < 8; ++i) b |= (x * (2u * i + 1u) < drop.thresh ? 1u : 0u) << i;
          if (lane < n) sc.bits[lane] = b;
        }"""


def _replace(src: str, pattern: str, new: str) -> str:
    out, n = re.subn(pattern, new, src)
    if n != 1:
        raise ValueError(f"the source holds {pattern!r} {n} times, not once")
    return out


def _cut_gat_fwd(src: str, left: str) -> str:
    """gat_fwd with only the stage `left` kept (see the module note)."""
    head, body = src.split("\ngat_fwd_kernel(", 1)
    body, tail = body.split("\n// per-edge quantities of the backward", 1)
    if left == "scores only":
        body = _replace(body, r"if \(sc\.bits\[k\] >> L\.hh & 1u\) \{",
                        "if (false) {")
    else:
        body = _replace(body, r"(?s)      // pass 1:.*?(?=      __syncwarp\(\);"
                        r"\n\n      // pass 2)",
                        "      if (lane < NH) sc.max[lane] = 0.f;\n")
        body = _replace(body, r"sc\.term\[lane \* NH \+ i\] = expf\(s - "
                        r"sc\.max\[i\]\);", "sc.term[lane * NH + i] = 1.f;")
        body = _replace(body, r"chunk_keep_bits\(drop, e0, n, H, h0, hn, "
                        r"sc\.bits\);", lambda _: _HASH_BITS)
    return (head + "\ngat_fwd_kernel(" + body
            + "\n// per-edge quantities of the backward" + tail)


def _variant_source(name: str, variant) -> str:
    if variant == "template":
        return (cuda_build._CSRC / cuda_build.SOURCES["spmm"]).read_text() \
            + _TEMPLATE_F32
    src = (cuda_build._CSRC / cuda_build.SOURCES[LIBRARY[name]]).read_text()
    if variant is None:
        return src
    if name == "f32":
        key, value = variant.split("=")
        const = {"S": "kStages", "T": "kChunkEdges", "H": "kCacheHints"}[key]
        return _replace(src, rf"constexpr int {const} = \d+;",
                        f"constexpr int {const} = {value};")
    if name == "softmax":
        return _replace(src, r"constexpr int kSoftmaxRegs = \d+;",
                        f"constexpr int kSoftmaxRegs = {variant};")
    if name == "gat_fwd_parts":
        return _cut_gat_fwd(src, variant)
    bounds = ("__launch_bounds__(kWarps * 32)" if not variant else
              f"__launch_bounds__(kWarps * 32, {variant})")
    return _replace(src, rf"__launch_bounds__\([^\n]*\)\n{KERNEL[name]}\(",
                    f"{bounds}\n{KERNEL[name]}(")


def _template_args(mangled) -> str:
    """A kernel's mangled template arguments as "8,1", "8,1,8,true" or
    "8,1,BwdItems 2" where all are ints, bools or enum values, else as
    mangled; "-" for none."""
    token = r"Li(\d+)E|Lb(\d)E|LNS_\d+([A-Za-z]\w*?)E(\d+)E"
    if not mangled:
        return "-"
    if not re.fullmatch(rf"(?:{token})+", mangled):
        return mangled
    return ",".join(n or ({"1": "true", "0": "false"}[b] if b
                          else f"{enum} {v}")
                    for n, b, enum, v in re.findall(token, mangled))


def ptxas_table(messages: str, kernel: str) -> dict:
    """{instantiation: {registers, stack, spill_stores}} of `kernel` from
    nvcc -Xptxas -v messages (template arguments as `_template_args`
    gives them)."""
    table, current = {}, None
    for line in messages.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}(?:I(.*?)EEv)?", line)
            args = m.group(1) if m else None
            current = _template_args(args) if m else None
            if current:
                table[current] = {}
        elif current:
            for n, what in re.findall(r"(\d+) (bytes stack frame|bytes spill "
                                      r"stores|registers)", line):
                key = {"bytes stack frame": "stack", "registers": "registers",
                       "bytes spill stores": "spill_stores"}[what]
                table[current][key] = int(n)
    return table


def _build(job) -> tuple:
    name, variant, tmp = job
    stem = re.sub(r"\W", "_", f"{name}_{variant}")
    cu = Path(tmp) / f"{stem}.cu"
    cu.write_text(_variant_source(name, variant))
    lib = Path(tmp) / f"lib{stem}.so"
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                          str(lib), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr)
    kernel = "spmm_csr_kernel" if variant == "template" else KERNEL[name]
    return job, lib, ptxas_table(res.stderr, kernel)


def _load(name: str, lib: Path, signatures: dict) -> None:
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in signatures.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    cuda_build._libs[name] = handle


def _geometries(f: int, itemsize: int, head_width=None):
    """Every lane layout the SpMM kernel takes for rows of f elements: each
    load width that divides f (and the head width), with the edge groups
    that fill the warp and with one group."""
    out, vec = [], 1
    while vec * itemsize <= 16 and vec <= 8:
        if f % vec == 0 and (head_width is None or head_width % vec == 0):
            lanes = min(32, -(-f // vec))
            out += [(vec, lanes, g) for g in sorted({32 // lanes, 1})]
        vec *= 2
    return out


def _time_geometries(name, call, f, itemsize, head_width=None) -> dict:
    """{geometry: ms} of one SpMM call under every lane layout; the port's
    own choice is marked with a '*'."""
    chosen = _port_geometry(f, itemsize, head_width)
    out = {}
    try:
        for geo in _geometries(f, itemsize, head_width):
            spmm_cuda.geometry = lambda *a, _geo=geo, **k: _geo
            out[f"{geo}{'*' if geo == chosen else ''}"] = \
                chip_smoke.time_ms(call)
    finally:
        spmm_cuda.geometry = _port_geometry
    print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()),
          flush=True)
    return out


def _time_spmm(g) -> dict:
    gen = torch.Generator(device=g.device).manual_seed(1)
    n, out = g.n_nodes, {}
    csr = spmm_cuda.weighted_csr(g)      # the graph's kept hub plans
    plan = csr.plan
    for f in WIDTHS:
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        q, s = spmm_cuda.quantize_cols(x)
        torch.testing.assert_close(
            spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n, plan),
            spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n),
            rtol=1e-5, atol=1e-4)
        out[f"bf16 F={f}"] = _time_geometries(
            f"bf16 F={f}",
            lambda: spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n, plan),
            f, 2)
        out[f"int8 F={f}"] = _time_geometries(
            f"int8 F={f}",
            lambda: spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n,
                                           plan), f, 1)
    x = torch.randn((n, 40), generator=gen, device=g.device)
    w = (torch.rand(g.n_edges, generator=gen, device=g.device)
         >= 0.5).float() * 2
    for walk, args in (("forward", (g.indptr, g.senders, None, csr.plan)),
                       ("transposed", (g.t_indptr, g.t_receivers,
                                       g.t_edges, csr.t_plan))):
        out[f"weighted F=40 {walk}"] = _time_geometries(
            f"weighted F=40 {walk}",
            lambda: spmm_cuda.csr_wsum_bf16(*args[:3], x, w, n, args[3]), 40,
            4, 40)
    xh = torch.randn((n, 128), generator=gen, device=g.device)
    wh = torch.rand((g.n_edges, 8), generator=gen, device=g.device)
    out["weighted (8, 16)"] = _time_geometries(
        "weighted (8, 16)",
        lambda: spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, xh, wh, n,
                                        plan), 128, 4, 16)
    return out


def _fwd_layouts(h: int, d: int):
    """Every lane layout gat_fwd takes at (h, d): each load width dividing
    d, with the slots that fill the warp and with one slot."""
    out, vec = [], 8
    while vec >= 1:
        if d % vec == 0:
            groups = d // vec
            reps = 1
            while reps * 32 < groups:
                reps *= 2
            if reps <= 4:
                lh = -(-groups // reps)
                hp = min(h, 32 // lh, gat_cuda.FWD_MAX_HEADS)
                for slots in sorted({32 // (hp * lh), 1}, reverse=True):
                    out.append((vec, reps, lh, hp, slots))
        vec //= 2
    return out


def _time_gat_fwd(g) -> dict:
    """gat_fwd (seed mode) under every lane layout and grid; the port's own
    choice is marked with a '*'."""
    out = {}
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes)
    for h, d in chip_smoke.GAT_SHAPES:
        args, _, _ = chip_smoke.gat_inputs(gat_cuda, g, h, d,
                                           chip_smoke.ATTN_DROP, 7)
        want = gat_cuda.plain_gat_fwd(*args)
        chosen = _port_fwd_geometry(h, d)
        times = {}
        try:
            for lanes in _fwd_layouts(h, d):
                geo = gat_cuda.FwdGeometry(*lanes)
                gat_cuda.fwd_geometry = lambda *a, _g=geo, **k: _g
                for grid in ("fill", "rows"):
                    gat_cuda._blocks = (_port_blocks if grid == "fill"
                                        else lambda *a: 1 << 30)
                    got = gat_cuda.gat_fwd(*args, plan=plan)
                    chip_smoke._held("out", got[0], want[0], 1e-4, 1e-4)
                    mark = "*" if geo == chosen and grid == "fill" else ""
                    times[f"{tuple(geo)} {grid}{mark}"] = chip_smoke.time_ms(
                        lambda: gat_cuda.gat_fwd(*args, plan=plan))
        finally:
            gat_cuda.fwd_geometry = _port_fwd_geometry
            gat_cuda._blocks = _port_blocks
        best = min(times, key=times.get)
        print(f"  gat_fwd ({h}, {d}): port's "
              f"{[v for k, v in times.items() if k.endswith('*')]} ms, best "
              f"{best} {times[best]:.4f} ms", flush=True)
        out[f"gat_fwd ({h}, {d})"] = times
    return out


def _time_gat_bwd(g) -> dict:
    out = {}
    for h, d in chip_smoke.GAT_SHAPES:
        args, dout, al_b = chip_smoke.gat_inputs(gat_cuda, g, h, d,
                                                 chip_smoke.ATTN_DROP, 7)
        plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes)
        _, smax, denom = gat_cuda.gat_fwd(*args, plan=plan)
        got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b, plan=plan)
        want = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
        chip_smoke._held("der", got[0], want[0], 1e-4, 1e-4)
        chip_smoke._held("msg", got[1], want[1], 2.0 ** -7, 1e-5)
        out[f"gat_bwd ({h}, {d})"] = chip_smoke.time_ms(
            lambda: gat_cuda.gat_bwd(*args, smax, denom, dout, al_b,
                                     plan=plan))
        gen = torch.Generator(device=g.device).manual_seed(12)
        feat = torch.randn((g.n_nodes, h, d), generator=gen, device=g.device)
        al, ar = (torch.randn((h, d), generator=gen, device=g.device)
                  for _ in range(2))
        out[f"gat_prep ({h}, {d})"] = chip_smoke.time_ms(
            lambda: gat_cuda.prep(feat, al, ar))
    print("  " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()),
          flush=True)
    return out


def _time_gat_fwd_parts(g, left) -> dict:
    """A cut gat_fwd (seed mode, the port's layout and grid) at both GAT
    shapes; its output is not gat_fwd's, so it is only timed."""
    out, left = {}, left or "whole"
    plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes)
    for h, d in chip_smoke.GAT_SHAPES:
        args, _, _ = chip_smoke.gat_inputs(gat_cuda, g, h, d,
                                           chip_smoke.ATTN_DROP, 7)
        out[f"gat_fwd ({h}, {d}) {left}"] = chip_smoke.time_ms(
            lambda: gat_cuda.gat_fwd(*args, plan=plan))
    print("  " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()),
          flush=True)
    return out


def _time_softmax(g, regs: int) -> dict:
    """edge_softmax_fwd built with R = regs scores per lane, with the edge
    slots per row that R implies."""
    out, n = {}, g.n_nodes
    gen = torch.Generator(device=g.device).manual_seed(8)
    plan = spmm_cuda.plan_of(g, "indptr", n)
    port_regs = gat_cuda.SOFTMAX_REGS
    gat_cuda.SOFTMAX_REGS = regs
    try:
        for h in (1, 8):
            s = 3.0 * torch.randn((g.n_edges, h), generator=gen,
                                  device=g.device)
            want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, n)
            torch.testing.assert_close(
                gat_cuda.edge_softmax_fwd(g.indptr, s, n, plan), want,
                rtol=1e-5, atol=1e-6)
            geo = gat_cuda.softmax_geometry(h, g.n_edges, n)
            mark = "*" if regs == port_regs else ""
            out[f"[E, {h}] {tuple(geo)}{mark}"] = chip_smoke.time_ms(
                lambda: gat_cuda.edge_softmax_fwd(g.indptr, s, n, plan))
    finally:
        gat_cuda.SOFTMAX_REGS = port_regs
    print("  edge_softmax_fwd " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in out.items()),
          flush=True)
    return out


def _f32_inputs(graphs) -> list:
    """(graph tag, F, graph, x, plan, plain sum, row magnitudes) of each f32
    case, x from a fixed seed."""
    out = []
    for tag, g in graphs.items():
        gen = torch.Generator(device=g.device).manual_seed(14)
        for f in F32_WIDTHS:
            x = torch.randn((g.n_nodes, f), generator=gen, device=g.device)
            want = refops.csr_sum_f32(g.indptr, g.senders, x, g.n_nodes)
            mag = refops.csr_sum_f32(g.indptr, g.senders, x.abs(), g.n_nodes)
            out.append((tag, f, g, x, want, mag))
    return out


def _held_f32(got, again, want, mag, what) -> None:
    if not bool(((got - want).abs() <= 1e-5 * mag).all()):
        raise AssertionError(f"{what}: over 1e-5 of a row's magnitude")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")


def _time_f32(cases, variant, lib) -> dict:
    """The f32 sum under each F32_COPIES (or, for "template", the template
    body at spmm_cuda.geometry's layout): {case: (eager ms, device ms)}."""
    out = {}
    if variant == "template":
        fn = lib.spmm_csr_template_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for tag, f, g, x, want, mag in cases:
            def call(g=g, x=x, f=f):
                o = torch.empty((g.n_nodes, f), device=g.device)
                cuda_build.launch("template f32", fn, g.device,
                                  g.indptr.data_ptr(), g.senders.data_ptr(),
                                  x.data_ptr(), o.data_ptr(), g.n_nodes, f,
                                  *spmm_cuda.geometry(f, 4,
                                                      align=x.data_ptr()))
                return o
            _held_f32(call(), call(), want, mag, f"template {tag} F={f}")
            out[f"{tag} F={f} {spmm_cuda.geometry(f, 4)}"] = \
                chip_smoke.kernel_times(call)
    else:
        chunk = spmm_cuda.F32_CHUNK
        if variant and variant.startswith("T="):
            spmm_cuda.F32_CHUNK = int(variant[2:])
        copies = spmm_cuda.F32_COPIES
        try:
            plans = {tag: spmm_cuda.hub_plan(g.indptr, g.n_nodes, spmm_cuda.F32_CHUNK)
                     for tag, _, g, *_ in cases}
            for spmm_cuda.F32_COPIES in F32_COPIES:
                for tag, f, g, x, want, mag in cases:
                    def call(g=g, x=x, plan=plans[tag]):
                        return spmm_cuda.csr_sum_f32(g.indptr, g.senders, x,
                                                     g.n_nodes, plan)
                    geo = tuple(spmm_cuda.f32_geometry(f))
                    _held_f32(call(), call(), want, mag,
                              f"{variant} {tag} F={f} {geo}")
                    mark = "*" if copies == spmm_cuda.F32_COPIES else ""
                    out[f"{tag} F={f} {geo}{mark}"] = \
                        chip_smoke.kernel_times(call)
        finally:
            spmm_cuda.F32_CHUNK, spmm_cuda.F32_COPIES = chunk, copies
    print("  f32 " + ", ".join(f"{k} {e:.4f} [{d:.4f}]"
                               for k, (e, d) in out.items()), flush=True)
    return out


def _chunk(t, per_step: int) -> int:
    """The T of HUB_CHUNKS entry t: edges, 64 per edge group (or slot)
    for "64G", and a T no row exceeds for None (unsplit)."""
    return 1 << 30 if t is None else 64 * per_step if t == "64G" else t


def _hub_times(tag, what, call, held, per_step, chunks=HUB_CHUNKS) -> dict:
    """{T: (eager ms, device ms)} of `call(plan)` under each plan of
    `chunks` (HUB_CHUNKS by default) of the CSR (indptr, n); `held(got)`
    holds one result to the plain version, and two launches must be
    bit-equal."""
    out = {}
    for t in chunks:
        chunk = _chunk(t, per_step)
        plan = spmm_cuda.hub_plan(*what, chunk)
        got, again = call(plan), call(plan)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        again if isinstance(again, tuple) else (again,)):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag} T={t}: two launches differ")
        held(got)
        key = f"T={'unsplit' if t is None else t} ({plan.n_chunks} chunks)"
        out[key] = chip_smoke.kernel_times(lambda p=plan: call(p))
    print(f"  {tag}: " + ", ".join(f"{k} {e:.4f} [{d:.4f}]"
                                   for k, (e, d) in out.items()), flush=True)
    return out


def _time_spmm_hub(graphs) -> dict:
    """The template body's three policies at F = 40 and 128 on each graph
    under each hub plan: {case: {T: (eager ms, device ms)}}."""
    out = {}
    for tag, g in graphs.items():
        gen = torch.Generator(device=g.device).manual_seed(16)
        n, ip, ix = g.n_nodes, g.indptr, g.senders
        w = (torch.rand(g.n_edges, generator=gen, device=g.device)
             >= 0.5).float() * 2
        for f in (40, 128):
            x = torch.randn((n, f), generator=gen, device=g.device)
            xb = spmm_cuda.to_message(x)
            q, s = spmm_cuda.quantize_cols(x)
            cases = {
                "bf16": (lambda p: spmm_cuda.csr_sum_bf16(ip, ix, xb, n, p),
                         spmm_cuda.plain_csr_sum_bf16(ip, ix, xb, n),
                         spmm_cuda.geometry(f, 2)),
                "int8": (lambda p: spmm_cuda.csr_sum_int8(ip, ix, q, s, n,
                                                          p),
                         spmm_cuda.plain_csr_sum_int8(ip, ix, q, s, n),
                         spmm_cuda.geometry(f, 1)),
                "weighted": (lambda p: spmm_cuda.csr_wsum_bf16(
                    ip, ix, None, x, w, n, p),
                    spmm_cuda.plain_csr_wsum_bf16(ip, ix, None, x, w, n),
                    spmm_cuda.geometry(f, 4, f))}
            for policy, (call, want, geo) in cases.items():
                def held(got, want=want, exact=policy == "int8"):
                    if exact and not torch.equal(got, want):
                        raise AssertionError("int8 differs from plain")
                    chip_smoke._held(policy, got, want, 1e-5, 1e-4)
                out[f"{tag} {policy} F={f} {geo}"] = _hub_times(
                    f"{tag} {policy} F={f}", (ip, n), call, held, geo[2])
    return out


def _time_gat_fwd_hub(graphs) -> dict:
    """gat_fwd (seed mode) at both GAT shapes on each graph under each
    GAT_FWD_CHUNKS plan: {case: {T: (eager ms, device ms)}}."""
    out = {}
    for tag, g in graphs.items():
        for h, d in chip_smoke.GAT_SHAPES:
            args, _, _ = chip_smoke.gat_inputs(gat_cuda, g, h, d,
                                               chip_smoke.ATTN_DROP, 7)
            want = gat_cuda.plain_gat_fwd(*args)

            def held(got, want=want):
                if not torch.equal(got[1], want[1]):
                    raise AssertionError("gat_fwd max differs from plain")
                chip_smoke._held("out", got[0], want[0], 1e-4, 1e-4)
                chip_smoke._held("denom", got[2], want[2], 1e-4, 1e-4)
            out[f"{tag} gat_fwd ({h}, {d})"] = _hub_times(
                f"{tag} gat_fwd ({h}, {d})", (g.indptr, g.n_nodes),
                lambda p, a=args: gat_cuda.gat_fwd(*a, plan=p), held,
                gat_cuda.fwd_geometry(h, d).slots, GAT_FWD_CHUNKS)
    return out


def _time_gat_bwd_hub(graphs) -> dict:
    """gat_bwd (seed mode) at both GAT shapes on each graph under each
    GAT_BWD_CHUNKS plan: {case: {T: (eager ms, device ms)}}."""
    out = {}
    for tag, g in graphs.items():
        plan = spmm_cuda.plan_of(g, "indptr", g.n_nodes, gat_cuda.GAT_CHUNK)
        for h, d in chip_smoke.GAT_SHAPES:
            args, dout, al_b = chip_smoke.gat_inputs(
                gat_cuda, g, h, d, chip_smoke.ATTN_DROP, 7)
            _, smax, denom = gat_cuda.gat_fwd(*args, plan=plan)
            bwd = args + (smax, denom, dout, al_b)
            want = gat_cuda.plain_gat_bwd(*bwd)

            def held(got, want=want):
                chip_smoke._held("der", got[0], want[0], 1e-4, 1e-4)
                chip_smoke._held("msg", got[1], want[1], 2.0 ** -7, 1e-5)
                chip_smoke._held("dattn_l", got[2], want[2], 1e-4, 1e-4)
            out[f"{tag} gat_bwd ({h}, {d})"] = _hub_times(
                f"{tag} gat_bwd ({h}, {d})", (g.indptr, g.n_nodes),
                lambda p, a=bwd: gat_cuda.gat_bwd(*a, plan=p), held,
                gat_cuda.bwd_geometry(h, d).slots, GAT_BWD_CHUNKS)
    return out


def _time_softmax_hub(graphs) -> dict:
    """edge_softmax_fwd on [E, 1] and [E, 8] scores on each graph under
    each SOFTMAX_CHUNKS plan: {case: {T: (eager ms, device ms)}}."""
    out = {}
    for tag, g in graphs.items():
        gen = torch.Generator(device=g.device).manual_seed(8)
        for h in (1, 8):
            s = 3.0 * torch.randn((g.n_edges, h), generator=gen,
                                  device=g.device)
            want = gat_cuda.plain_edge_softmax_fwd(g.indptr, s, g.n_nodes)

            def held(got, want=want):
                chip_smoke._held("alpha", got, want, 1e-5, 1e-6)
            out[f"{tag} edge_softmax_fwd [E, {h}]"] = _hub_times(
                f"{tag} edge_softmax_fwd [E, {h}]", (g.indptr, g.n_nodes),
                lambda p, s=s: gat_cuda.edge_softmax_fwd(g.indptr, s,
                                                         g.n_nodes, p),
                held, 32 // gat_cuda.softmax_geometry(h, 1, 1).g,
                SOFTMAX_CHUNKS)
    return out


def _time_softmax_bwd_hub(graphs) -> dict:
    """edge_softmax_bwd on the alpha of [E, 1] and [E, 8] scores on each
    graph under each SOFTMAX_CHUNKS plan: {case: {T: (eager ms, device
    ms)}}."""
    out = {}
    for tag, g in graphs.items():
        gen = torch.Generator(device=g.device).manual_seed(9)
        n = g.n_nodes
        plan = spmm_cuda.plan_of(g, "indptr", n)
        for h in (1, 8):
            s = 3.0 * torch.randn((g.n_edges, h), generator=gen,
                                  device=g.device)
            da = torch.randn((g.n_edges, h), generator=gen, device=g.device)
            alpha = gat_cuda.edge_softmax_fwd(g.indptr, s, n, plan)
            want = gat_cuda.plain_edge_softmax_bwd(g.indptr, alpha, da, n)

            def held(got, want=want):
                chip_smoke._held("ds", got, want, 1e-4, 1e-6)
            out[f"{tag} edge_softmax_bwd [E, {h}]"] = _hub_times(
                f"{tag} edge_softmax_bwd [E, {h}]", (g.indptr, n),
                lambda p, a=alpha, da=da: gat_cuda.edge_softmax_bwd(
                    g.indptr, a, da, n, p),
                held, 32 // gat_cuda.softmax_geometry(h, 1, 1).g,
                SOFTMAX_CHUNKS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sweep_cuda_kernels.json")
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ", ".join(VARIANTS))
    opts = ap.parse_args()
    out_path, kernels = opts.out, opts.kernels.split(",")
    if not torch.cuda.is_available():
        print("sweep_cuda_kernels: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    host, *_ = load_synth_data(chip_smoke.DATASET, 0, 20, 30)
    g = host.to_device(torch.device("cuda:0"))
    graphs = {"synth": g}
    if {"f32", "spmm_hub", "gat_fwd_hub", "gat_bwd_hub", "softmax_hub",
            "softmax_bwd_hub"} & set(kernels):
        graphs["hub"] = chip_smoke.hub_graph(g.n_nodes, g.n_edges,
                                             9).to(g.device)
    f32_cases = _f32_inputs(graphs) if "f32" in kernels else []
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(name, b, tmp) for name, bs in VARIANTS.items()
                if name in kernels for b in bs]
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            built = list(pool.map(_build, jobs))
        for (name, variant, _), lib, ptxas in built:
            library = LIBRARY[name]
            sigs = {"spmm": spmm_cuda._SIGNATURES, "gat": gat_cuda._SIGNATURES,
                    "spmm_f32": spmm_cuda._F32_SIGNATURES}[library]
            if variant == "template":     # beside the port's library
                times = _time_f32(f32_cases, variant, ctypes.CDLL(str(lib)))
                rows.append(dict(kernel=name, variant=variant, ptxas=ptxas,
                                 ms=times))
                print(f"{name} variant {variant}: ptxas {ptxas}", flush=True)
                continue
            _load(library, lib, sigs)
            gat_cuda._blocks_per_sm.clear()
            if name == "f32":
                times = _time_f32(f32_cases, variant, None)
            elif name == "spmm":
                times = _time_spmm(g)
            elif name == "spmm_hub":
                times = _time_spmm_hub(graphs)
            elif name == "gat_fwd_hub":
                times = _time_gat_fwd_hub(graphs)
            elif name == "gat_bwd_hub":
                times = _time_gat_bwd_hub(graphs)
            elif name == "softmax_hub":
                times = _time_softmax_hub(graphs)
            elif name == "softmax_bwd_hub":
                times = _time_softmax_bwd_hub(graphs)
            elif name == "gat_fwd":
                times = _time_gat_fwd(g)
            elif name == "gat_fwd_parts":
                times = _time_gat_fwd_parts(g, variant)
            elif name == "softmax":
                times = _time_softmax(g, variant or gat_cuda.SOFTMAX_REGS)
            else:
                times = _time_gat_bwd(g)
            rows.append(dict(kernel=name, variant=variant, ptxas=ptxas,
                             ms=times))
            print(f"{name} variant {variant}: ptxas {ptxas}", flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"device": smi, "variants": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
