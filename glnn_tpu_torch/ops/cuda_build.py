"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by its own nvcc call (sm_90a, plain C
interface) into its own shared library under `build/glnn_tpu_torch/`, and
loaded with ctypes. A library is rebuilt when it is missing or older than
its own source, so a change to any one source rebuilds that library.
`build()` starts every stale compile at once and waits for all of them.
Every C entry point launches on the stream it is given, never
synchronises, allocates nothing, and returns `cudaGetLastError()`;
`launch` raises when that is not 0. There is no fallback.

What the kernel modules share besides: `counts["plain_on_cuda"]`, the
calls of a plain version (a kernel module's, or the dispatcher's f32 tier)
that were handed CUDA tensors, which every path must leave at 0; and
`row_ids`, the CSR helper of the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glnn_tpu_torch"
# library name -> its source in csrc/
SOURCES = {"spmm": "spmm_csr.cu", "spmm_f32": "spmm_f32.cu",
           "gat": "gat_csr.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
counts = {"plain_on_cuda": 0}


def reset_counts() -> None:
    counts["plain_on_cuda"] = 0


def note_plain(x: torch.Tensor) -> None:
    """Count a plain-version call on a CUDA tensor."""
    if x.is_cuda:
        counts["plain_on_cuda"] += 1


def row_ids(indptr: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The row (dst) of each edge of a CSR: int64[indptr[n_rows]]."""
    deg = (indptr[1:n_rows + 1] - indptr[:n_rows]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), deg)


def _source(name: str) -> Path:
    return _CSRC / SOURCES[name]


def _library(name: str) -> Path:
    return _BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _stale(name: str) -> bool:
    lib = _library(name)
    return (not lib.exists()
            or lib.stat().st_mtime < _source(name).stat().st_mtime)


def _compile(name: str) -> str:
    lib = _library(name)
    tmp = lib.with_name(f"lib{name}.{os.getpid()}.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(_source(name))], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_source(name)}:\n{res.stderr}")
    os.replace(tmp, lib)
    return res.stderr


def build(names=None, force: bool = False) -> dict:
    """Compile each named source (all by default) whose library is missing
    or out of date, one nvcc per source, all at once. Returns each compiled
    library's compiler messages (ptxas register and spill counts); raises
    on the first failure."""
    names = [n for n in (SOURCES if names is None else names)
             if force or _stale(n)]
    if not names:
        return {}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_compile, names)))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library `name`, built at first use; `signatures` maps each entry
    point to its ctypes argument types (every one returns an int)."""
    if name not in _libs:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn` with `args` and the current stream of
    `device`; raise if it reports a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
