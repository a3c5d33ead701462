#!/usr/bin/env python3
"""Time variants of the port's two redesigned CUDA kernels on one GPU.

    python3 tools/sweep_cuda_kernels.py [--out PATH]   # from the repository root

Each variant is the source in glnn_tpu_torch/csrc with one bound changed
in a copy: the minimum resident blocks per SM asked of ptxas
(__launch_bounds__) for the CSR SpMM body (spmm_csr.cu) or for gat_bwd
(gat_csr.cu), which caps the registers a thread may use. Every variant
is built with the port's nvcc flags into a temporary directory, loaded in
place of the port's library, checked against the plain version, and timed
with CUDA events on the synth-n169343-c40-f128-d7 graph at the main
paths' widths: the exact and int8 sums at F = 40, 64, 128, 256, the
weighted sum at F = 40 (forward and transposed walk) and per head at
(8, 16), each under every lane layout the kernel takes (the geometry is a
launch argument, so these need no rebuild), and gat_bwd at (8, 16) and
(1, 40) with the attention dropout mask. Prints each variant's ptxas registers and spill stores per
instantiation and its times, and writes them all to PATH as JSON (by
default build/sweep_cuda_kernels.json).
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
from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda  # noqa: E402

_port_geometry = spmm_cuda.geometry

# the minimum blocks per SM of each variant; None: as the source has it,
# 0: no minimum
SPMM_VARIANTS = [None, 6, 0]
GAT_VARIANTS = [None, 0]
WIDTHS = (40, 64, 128, 256)


def _replace(src: str, pattern: str, new: str) -> str:
    out, n = re.subn(pattern, new, src)
    if n != 1:
        raise ValueError(f"the source holds {pattern!r} {n} times, not once")
    return out


def _variant_source(name: str, min_blocks) -> str:
    src = (cuda_build._CSRC / cuda_build.SOURCES[name]).read_text()
    if min_blocks is None:
        return src
    kernel = "spmm_csr_kernel" if name == "spmm" else "gat_bwd_kernel"
    bounds = ("__launch_bounds__(kWarps * 32)" if not min_blocks else
              f"__launch_bounds__(kWarps * 32, {min_blocks})")
    return _replace(src, rf"__launch_bounds__\([^\n]*\)\n{kernel}\(",
                    f"{bounds}\n{kernel}(")


def _build(job) -> tuple:
    name, min_blocks, tmp = job
    stem = f"{name}_b{min_blocks}"
    cu = Path(tmp) / f"{stem}.cu"
    cu.write_text(_variant_source(name, min_blocks))
    lib = Path(tmp) / f"lib{stem}.so"
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                          str(lib), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr)
    kernel = "spmm_csr_kernel" if name == "spmm" else "gat_bwd_kernel"
    ptxas, current = [], None
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            current = line if kernel in line else None
        elif current and ("registers" in line or "spill" in line):
            nums = re.findall(r"(\d+) (bytes spill stores|registers)", line)
            ptxas += [f"{n} {what.split()[-1]}" for n, what in nums]
    return job, lib, ptxas


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
    for f in WIDTHS:
        x = torch.randn((n, f), generator=gen, device=g.device)
        xb = spmm_cuda.to_message(x)
        q, s = spmm_cuda.quantize_cols(x)
        torch.testing.assert_close(
            spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n),
            spmm_cuda.plain_csr_sum_bf16(g.indptr, g.senders, xb, n),
            rtol=1e-5, atol=1e-4)
        out[f"bf16 F={f}"] = _time_geometries(
            f"bf16 F={f}",
            lambda: spmm_cuda.csr_sum_bf16(g.indptr, g.senders, xb, n), f, 2)
        out[f"int8 F={f}"] = _time_geometries(
            f"int8 F={f}",
            lambda: spmm_cuda.csr_sum_int8(g.indptr, g.senders, q, s, n), f, 1)
    x = torch.randn((n, 40), generator=gen, device=g.device)
    w = (torch.rand(g.n_edges, generator=gen, device=g.device)
         >= 0.5).float() * 2
    for walk, args in (("forward", (g.indptr, g.senders, None)),
                       ("transposed", (g.t_indptr, g.t_receivers,
                                       g.t_edges))):
        out[f"weighted F=40 {walk}"] = _time_geometries(
            f"weighted F=40 {walk}",
            lambda: spmm_cuda.csr_wsum_bf16(*args, x, w, n), 40, 4, 40)
    xh = torch.randn((n, 128), generator=gen, device=g.device)
    wh = torch.rand((g.n_edges, 8), generator=gen, device=g.device)
    out["weighted (8, 16)"] = _time_geometries(
        "weighted (8, 16)",
        lambda: spmm_cuda.csr_wsum_bf16(g.indptr, g.senders, None, xh, wh, n),
        128, 4, 16)
    return out


def _time_gat(g) -> dict:
    out = {}
    for h, d in chip_smoke.GAT_SHAPES:
        args, dout, al_b = chip_smoke.gat_inputs(gat_cuda, g, h, d,
                                                 chip_smoke.ATTN_DROP, 7)
        _, smax, denom = gat_cuda.gat_fwd(*args)
        got = gat_cuda.gat_bwd(*args, smax, denom, dout, al_b)
        want = gat_cuda.plain_gat_bwd(*args, smax, denom, dout, al_b)
        chip_smoke._held("der", got[0], want[0], 1e-4, 1e-4)
        chip_smoke._held("msg", got[1], want[1], 2.0 ** -7, 1e-5)
        out[f"gat_bwd ({h}, {d})"] = chip_smoke.time_ms(
            lambda: gat_cuda.gat_bwd(*args, smax, denom, dout, al_b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sweep_cuda_kernels.json")
    out_path = ap.parse_args().out
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
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        jobs = ([("spmm", b, tmp) for b in SPMM_VARIANTS]
                + [("gat", b, tmp) for b in GAT_VARIANTS])
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            built = list(pool.map(_build, jobs))
        for (name, min_blocks, _), lib, ptxas in built:
            sigs = (spmm_cuda._SIGNATURES if name == "spmm"
                    else gat_cuda._SIGNATURES)
            _load(name, lib, sigs)
            gat_cuda._blocks_per_sm.clear()
            times = _time_spmm(g) if name == "spmm" else _time_gat(g)
            rows.append(dict(kernel=name, min_blocks=min_blocks,
                             ptxas=ptxas, ms=times))
            print(f"{name} min_blocks {min_blocks}: ptxas {ptxas}",
                  flush=True)
            if name == "gat":
                print("  " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in times.items()), flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"device": smi, "variants": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
