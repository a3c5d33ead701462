"""The host graph operations of ingest and the locality relabel
(`glnn_tpu/native/__init__.py`): a ctypes binding to the port's own C++
library, `glnn_tpu_torch/csrc/graphops.cpp`, with a numpy and scipy tier
that gives the same arrays.

The native tier compiles that source with g++ into
`build/glnn_tpu_torch/libgraphops.so` at first use, and again whenever the
library is older than its source. The numpy tier runs only where no g++ is
on PATH. With g++ there, a compile or load that fails raises with the
compiler's messages: a silent switch to the numpy tier would hide a run
that is many times slower at ogbn-products scale. `counts` holds the
native calls per entry point; `describe()` names the tier as a run's log
shows it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "graphops.cpp"
BUILD_DIR = _REPO / "build" / "glnn_tpu_torch"
LIBRARY = "libgraphops.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64
SIGNATURES = {
    "sort_edges": [_i64, _i64p, _i64, _i64p],
    "coo_to_csr": [_i64, _i64, _i64p, _i64p, _i64p, _i64p],
    "to_bidirected": [_i64, _i64, _i64p, _i64p, _i64p, _i64p],
    "connected_components": [_i64, _i64, _i64p, _i64p, _i64p],
    "induced_subgraph": [_i64, _i64, _i64p, _i64p, _i64, _i64p, _i64p,
                         _i64p, _i64p],
    "label_propagation": [_i64, _i64, _i64p, _i64p, _i64, _i64p],
}

counts = dict.fromkeys(SIGNATURES, 0)
_loaded: dict = {}     # "lib": the process's library, None without g++


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def build(build_dir=BUILD_DIR, force: bool = False) -> Path | None:
    """Compile SOURCE into `build_dir`/libgraphops.so when that is missing
    or older than the source (or `force`); returns its path, or None when
    no g++ is on PATH. g++ writes a file of a name unique to this call,
    which then replaces the library in one rename, so processes that build
    at once each load a whole library. Raises with g++'s messages when the
    compile fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    lib = Path(build_dir) / LIBRARY
    if (force or not lib.exists()
            or lib.stat().st_mtime < SOURCE.stat().st_mtime):
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix="libgraphops.", suffix=".so",
                                   dir=lib.parent)
        os.close(fd)
        try:
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def load(build_dir=BUILD_DIR):
    """The library of `build_dir` (built first when stale) with its entry
    points declared, or None when no g++ is on PATH. Raises when the
    library does not load."""
    path = build(build_dir)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as err:
        raise RuntimeError(f"{path}, built from {SOURCE}, does not load: "
                           f"{err}") from err
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _lib():
    if "lib" not in _loaded:
        _loaded["lib"] = load(BUILD_DIR)
    return _loaded["lib"]


def available() -> bool:
    """The native tier runs (g++ found; the library built and loaded)."""
    return _lib() is not None


def describe() -> str:
    """The tier, as a run's log names it."""
    if not available():
        return "numpy (no g++ on PATH)"
    return f"native ({os.path.relpath(BUILD_DIR / LIBRARY, _REPO)})"


def _call(name: str, *args) -> int:
    counts[name] += 1
    return getattr(_lib(), name)(*args)


def _p(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.int64))


def _ids(name: str, a, n: int) -> np.ndarray:
    """`a` as contiguous int64, every value in [0, n): the library indexes
    its arrays with them unchecked."""
    a = _c64(a)
    if a.ndim != 1:
        raise ValueError(f"{name} must be 1-D")
    if a.size and (a.min() < 0 or a.max() >= n):
        raise ValueError(f"{name} ids must lie in [0, {n})")
    return a


def _edges(src, dst, n: int) -> tuple[np.ndarray, np.ndarray]:
    src, dst = _ids("src", src, n), _ids("dst", dst, n)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    return src, dst


def sort_edges(key, n: int) -> np.ndarray:
    """The stable sort permutation (int64) of `key`, values in [0, n): a
    counting sort, O(E + n)."""
    key = _ids("key", key, n)
    if not available():
        return np.argsort(key, kind="stable")
    order = np.empty(key.shape[0], np.int64)
    _call("sort_edges", key.shape[0], _p(key), n, _p(order))
    return order


def coo_to_csr(src, dst, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(indptr [n+1], indices) of the rows `src`, each row's entries in
    edge order."""
    src, dst = _edges(src, dst, n)
    e = src.shape[0]
    if not available():
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
        return indptr, dst[order]
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(e, np.int64)
    _call("coo_to_csr", n, e, _p(src), _p(dst), _p(indptr), _p(indices))
    return indptr, indices


def to_bidirected(src, dst, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrise and deduplicate, sorted by the key src * n + dst."""
    src, dst = _edges(src, dst, n)
    e = src.shape[0]
    if not available():
        s2 = np.concatenate([src, dst])
        d2 = np.concatenate([dst, src])
        _, keep = np.unique(s2 * n + d2, return_index=True)
        return s2[keep], d2[keep]
    so = np.empty(2 * e, np.int64)
    do = np.empty(2 * e, np.int64)
    m = _call("to_bidirected", n, e, _p(src), _p(dst), _p(so), _p(do))
    return so[:m].copy(), do[:m].copy()


def connected_components(src, dst, n: int) -> tuple[int, np.ndarray]:
    """(count, int64 label per node) of the weakly connected components,
    numbered in the order of each one's first node."""
    src, dst = _edges(src, dst, n)
    if not available():
        import scipy.sparse as sp

        adj = sp.csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                            shape=(n, n))
        k, comp = sp.csgraph.connected_components(adj, directed=False)
        return int(k), comp.astype(np.int64)
    comp = np.empty(n, np.int64)
    k = _call("connected_components", n, src.shape[0], _p(src), _p(dst),
              _p(comp))
    return int(k), comp


def induced_subgraph(src, dst, n: int, idx) -> tuple[np.ndarray, np.ndarray]:
    """The edges with both ends in idx, relabelled so that new id i is
    idx[i], in their original order (self-loops on idx survive)."""
    src, dst = _edges(src, dst, n)
    idx = _ids("idx", idx, n)
    e, k = src.shape[0], idx.shape[0]
    if not available():
        new_id = np.full(n, -1, np.int64)
        new_id[idx] = np.arange(k)
        keep = (new_id[src] >= 0) & (new_id[dst] >= 0)
        return new_id[src[keep]], new_id[dst[keep]]
    new_id = np.empty(n, np.int64)
    so = np.empty(max(e, 1), np.int64)
    do = np.empty(max(e, 1), np.int64)
    m = _call("induced_subgraph", n, e, _p(src), _p(dst), k, _p(idx),
              _p(new_id), _p(so), _p(do))
    return so[:m].copy(), do[:m].copy()


def label_propagation(src, dst, n: int, iters: int = 10):
    """The native sweep of `distributed.partition.label_propagation_labels`
    (int64[n] labels), or None on the numpy tier, whose sweep lives there."""
    if not available():
        return None
    src, dst = _edges(src, dst, n)
    labels = np.empty(n, np.int64)
    _call("label_propagation", n, src.shape[0], _p(src), _p(dst), iters,
          _p(labels))
    return labels
