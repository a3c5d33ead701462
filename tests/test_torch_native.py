"""The port's host-graph library (`glnn_tpu_torch.native`, built from
`glnn_tpu_torch/csrc/graphops.cpp`) against the JAX package's
(`glnn_tpu.native`, which loads `native/libglnnops.so`) and against the
port's own numpy tier: every entry point's arrays bit-equal on random
graphs with multi-edges, self-loops and isolated nodes, an empty edge list
and a one-node graph; the label propagation on planted communities; the
largest component where two components tie. Also the library's origin
(never the JAX package's file), concurrent builds into one directory, the
rebuild of a stale library, and what happens without g++ and with a broken
one."""

import os
import stat
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from glnn_tpu import native as jnative
from glnn_tpu_torch import native
from glnn_tpu_torch.distributed import partition as tpart
from glnn_tpu_torch.graph import host as thost

REPO = Path(__file__).resolve().parent.parent

# (nodes, edges): a multigraph over a third of the ids (the rest isolated);
# a dense multigraph; no edges; one node with self-loops; one node alone
CASES = {"sparse": (300, 800), "dense": (40, 2000), "empty": (10, 0),
         "one-node": (1, 3), "one-node-empty": (1, 0)}


def _graph(case: str, seed: int = 0):
    n, e = CASES[case]
    rs = np.random.RandomState(seed)
    hi = max(1, n // 3) if case == "sparse" else n
    src, dst = rs.randint(0, hi, e), rs.randint(0, hi, e)
    if e >= 40:
        src[:8] = dst[:8]                                   # self-loops
        src[8:16], dst[8:16] = src[16:24], dst[16:24]       # multi-edges
    return src.astype(np.int64), dst.astype(np.int64), n


def _numpy_tier(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _three_ways(monkeypatch, port_fn, jax_fn):
    """(port native, JAX's library, port numpy tier) results."""
    assert native.available() and jnative.available()
    got = port_fn()
    want = jax_fn()
    with monkeypatch.context() as m:
        _numpy_tier(m)
        numpy_got = port_fn()
    return got, want, numpy_got


def _equal(*results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            assert len(first) == len(other)
            for a, b in zip(first, other):
                np.testing.assert_array_equal(a, b)
                assert np.asarray(a).dtype == np.asarray(b).dtype
        else:
            np.testing.assert_array_equal(first, other)


@pytest.mark.parametrize("case", CASES)
def test_sort_edges_is_the_stable_argsort(case, monkeypatch):
    _, dst, n = _graph(case)
    before = native.counts["sort_edges"]
    got = native.sort_edges(dst, n + 1)
    assert native.counts["sort_edges"] == before + 1
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.argsort(dst, kind="stable"))
    from glnn_tpu.graph.container import _sort_by_dst    # JAX's caller
    np.testing.assert_array_equal(got, _sort_by_dst(dst, n + 1))
    _numpy_tier(monkeypatch)
    np.testing.assert_array_equal(native.sort_edges(dst, n + 1), got)
    assert native.counts["sort_edges"] == before + 1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", ["coo_to_csr", "to_bidirected",
                                "connected_components"])
def test_edge_ops_equal_jax_and_numpy_tier(case, op, monkeypatch):
    src, dst, n = _graph(case, seed=1)
    results = _three_ways(monkeypatch,
                          lambda: getattr(native, op)(src, dst, n),
                          lambda: getattr(jnative, op)(src, dst, n))
    _equal(*results)


@pytest.mark.parametrize("case", CASES)
def test_induced_subgraph_equals_jax_and_numpy_tier(case, monkeypatch):
    src, dst, n = _graph(case, seed=2)
    rs = np.random.RandomState(3)
    for idx in (rs.permutation(n)[: max(1, n // 2)], np.arange(n),
                np.zeros(0, np.int64)):
        _equal(*_three_ways(
            monkeypatch, lambda: native.induced_subgraph(src, dst, n, idx),
            lambda: jnative.induced_subgraph(src, dst, n, idx)))


def _planted(seed, n=3000, k=6, e=24000, p_in=0.9):
    rs = np.random.RandomState(seed)
    comm = rs.randint(0, k, n)
    members = [np.nonzero(comm == c)[0] for c in range(k)]
    src = rs.randint(0, n, e)
    dst = np.where(rs.rand(e) < p_in,
                   [members[comm[s]][rs.randint(len(members[comm[s]]))]
                    for s in src], rs.randint(0, n, e))
    return src.astype(np.int64), dst.astype(np.int64), n


@pytest.mark.parametrize("seed", [7, 8])
def test_label_propagation_equals_jax_and_numpy_tier(seed, monkeypatch):
    from glnn_tpu.distributed import partition as jpart

    src, dst, n = _planted(seed)
    got = native.label_propagation(src, dst, n)
    np.testing.assert_array_equal(got, jnative.label_propagation(src, dst, n))
    np.testing.assert_array_equal(tpart.label_propagation_labels(src, dst, n),
                                  got)
    np.testing.assert_array_equal(jpart.label_propagation_labels(src, dst, n),
                                  got)
    assert len(np.unique(got)) < n // 10          # communities were found
    _numpy_tier(monkeypatch)
    assert native.label_propagation(src, dst, n) is None
    np.testing.assert_array_equal(tpart.label_propagation_labels(src, dst, n),
                                  got)


@pytest.mark.parametrize("case", ["sparse", "one-node", "one-node-empty"])
def test_label_propagation_small_cases(case, monkeypatch):
    src, dst, n = _graph(case, seed=4)
    got = tpart.label_propagation_labels(src, dst, n)
    np.testing.assert_array_equal(got, jnative.label_propagation(src, dst, n))
    _numpy_tier(monkeypatch)
    np.testing.assert_array_equal(tpart.label_propagation_labels(src, dst, n),
                                  got)


def _tied_components():
    """Components {1, 4, 6, 9} and {0, 3, 7, 8} tie for the largest (four
    nodes each; the second holds node 0, the first the root of no
    union-find order); {2, 5} and isolated 10, 11. Edges listed so that
    union-find roots are the components' last nodes."""
    src = np.array([9, 6, 4, 8, 7, 3, 5])
    dst = np.array([6, 4, 1, 7, 3, 0, 2])
    return src, dst, 12


@pytest.mark.parametrize("graph", ["tie", "sparse", "dense"])
def test_largest_connected_component_equals_jax(graph, monkeypatch):
    from glnn_tpu.graph import host as jhost

    src, dst, n = (_tied_components() if graph == "tie"
                   else _graph(graph, seed=5))
    want = jhost.largest_connected_component(jhost.HostGraph(src, dst, n))
    with monkeypatch.context() as m:       # JAX's scipy tier picks the same
        m.setattr(jnative, "available", lambda: False)
        m.setattr(jnative, "_load", lambda: None)
        np.testing.assert_array_equal(jhost.largest_connected_component(
            jhost.HostGraph(src, dst, n)), want)
    got = thost.largest_connected_component(thost.HostGraph(src, dst, n))
    np.testing.assert_array_equal(got, want)
    if graph == "tie":
        np.testing.assert_array_equal(got, [0, 3, 7, 8])
    _numpy_tier(monkeypatch)
    np.testing.assert_array_equal(
        thost.largest_connected_component(thost.HostGraph(src, dst, n)), want)


@pytest.mark.parametrize("call", [
    lambda: native.sort_edges([0, 5], 5),
    lambda: native.coo_to_csr([0, 1], [1, -1], 3),
    lambda: native.induced_subgraph([0], [1], 3, [3]),
    lambda: native.label_propagation([0, 4], [1, 2], 4),
], ids=["sort_edges", "coo_to_csr", "induced_subgraph", "label_propagation"])
def test_ids_out_of_range_raise_before_the_library(call):
    with pytest.raises(ValueError, match="must lie in"):
        call()


def test_library_is_built_from_the_port_source_and_never_jaxs():
    """In a fresh interpreter every entry point runs natively, and the
    only graph library mapped is build/glnn_tpu_torch/libgraphops.so."""
    code = """
import numpy as np
from glnn_tpu_torch import native
rs = np.random.RandomState(0)
s, d = rs.randint(0, 50, 400), rs.randint(0, 50, 400)
native.sort_edges(d, 50)
native.coo_to_csr(s, d, 50)
native.to_bidirected(s, d, 50)
native.connected_components(s, d, 50)
native.induced_subgraph(s, d, 50, np.arange(10))
native.label_propagation(s, d, 50)
assert all(v == 1 for v in native.counts.values()), native.counts
with open("/proc/self/maps") as f:
    print("\\n".join(sorted({line.split()[-1] for line in f
                             if ".so" in line.split()[-1]})))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    libs = res.stdout.split()
    assert str(native.BUILD_DIR / native.LIBRARY) in libs
    assert native.BUILD_DIR == REPO / "build" / "glnn_tpu_torch"
    assert native.SOURCE == REPO / "glnn_tpu_torch" / "csrc" / "graphops.cpp"
    assert not [p for p in libs if "libglnnops" in p or "/native/" in p]
    assert native.describe() == "native (build/glnn_tpu_torch/libgraphops.so)"


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Two processes that build into one empty directory at the same moment
    both load a library that sorts right; no temporary file is left."""
    code = """
import sys, time
from pathlib import Path
import numpy as np
from glnn_tpu_torch import native
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
lib = native.load(Path(sys.argv[1]))
key = np.random.RandomState(0).randint(0, 100, 1000).astype(np.int64)
order = np.empty(1000, np.int64)
lib.sort_edges(1000, native._p(key), 100, native._p(order))
assert (order == np.argsort(key, kind="stable")).all()
print("ok")
"""
    build = tmp_path / "build"
    start = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), start],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == "ok", err
    assert sorted(os.listdir(build)) == [native.LIBRARY]


def test_stale_library_is_rebuilt(tmp_path):
    lib = native.build(tmp_path)
    first = lib.stat().st_mtime_ns
    assert native.build(tmp_path).stat().st_mtime_ns == first    # fresh
    old = native.SOURCE.stat().st_mtime - 60
    os.utime(lib, (old, old))
    assert native.build(tmp_path).stat().st_mtime >= native.SOURCE.stat(
        ).st_mtime
    assert sorted(os.listdir(tmp_path)) == [native.LIBRARY]


def test_without_gpp_the_numpy_tier_gives_the_same_arrays(tmp_path,
                                                          monkeypatch):
    src, dst, n = _graph("sparse", seed=6)
    idx = np.arange(0, n, 3)
    calls = (lambda: native.sort_edges(dst, n),
             lambda: native.coo_to_csr(src, dst, n),
             lambda: native.to_bidirected(src, dst, n),
             lambda: native.connected_components(src, dst, n),
             lambda: native.induced_subgraph(src, dst, n, idx),
             lambda: tpart.label_propagation_labels(src, dst, n))
    want = [call() for call in calls]
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.reset_counts()
    assert not native.available()
    assert native.describe() == "numpy (no g++ on PATH)"
    for call, w in zip(calls, want):
        _equal(w, call())
    assert not any(native.counts.values())
    assert not (tmp_path / "build").exists()


def _fake_gpp(bin_dir: Path, body: str) -> None:
    bin_dir.mkdir()
    path = bin_dir / "g++"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


@pytest.mark.parametrize("body,match", [
    ('echo "graphops.cpp:1: error: broken compiler" >&2\nexit 1\n',
     "(?s)g\\+\\+ failed.*broken compiler"),
    ('while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done\n'
     'echo junk > "$out"\n', "does not load"),
], ids=["compile-fails", "load-fails"])
def test_a_failing_gpp_raises(tmp_path, monkeypatch, body, match):
    """With a g++ on PATH, a compile that fails, or a library that does not
    load, raises with the reason; the numpy tier is never taken."""
    _fake_gpp(tmp_path / "bin", body)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.raises(RuntimeError, match=match):
        native.load(tmp_path / "other")
    assert [p.name for p in (tmp_path / "build").iterdir()] in (
        [], [native.LIBRARY])
