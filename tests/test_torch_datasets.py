"""glnn_tpu_torch's dataset layer against glnn_tpu's on the same tiny files.

Each test writes a few files in one family's on-disk format and loads them
through `glnn_tpu.graph.datasets` and `glnn_tpu_torch.graph.datasets`:
`src` and `dst` (in order), `n_nodes`, labels and the three index arrays
must be equal, and the features bit-equal, except BGNN's, which may differ
by one f32 ulp where Python's float parse of a CSV field differs from
pandas' own (none does on these files: they are equal). Also: the
`sparse.py` and `host.py` functions against their JAX counterparts, the
BGNN loader with pandas and sklearn unimportable, and both CLIs on a tiny
cora and a tiny ogbn-arxiv file.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from glnn_tpu.graph import datasets as jds
from glnn_tpu.graph import host as jhost
from glnn_tpu.graph import sparse as jsp
from glnn_tpu_torch.graph import datasets as tds
from glnn_tpu_torch.graph import host as thost
from glnn_tpu_torch.graph import sparse as tsp
from native_tiers import tier  # noqa: F401  (fixture: native, numpy)

REPO = Path(__file__).resolve().parent.parent


def _same(want, got, feat_ulps=0):
    """Both loaders' (g, labels, idx_train, idx_val, idx_test) equal."""
    gw, *rest_w = want
    gt, *rest_t = got
    assert gt.n_nodes == gw.n_nodes
    np.testing.assert_array_equal(gt.src, gw.src)
    np.testing.assert_array_equal(gt.dst, gw.dst)
    assert gt.src.dtype == gw.src.dtype == np.int64
    fw, ft = np.asarray(gw.ndata["feat"]), gt.ndata["feat"]
    assert ft.dtype == fw.dtype == np.float32 and ft.shape == fw.shape
    if feat_ulps:
        np.testing.assert_array_max_ulp(ft, fw, maxulp=feat_ulps)
    else:
        np.testing.assert_array_equal(ft, fw)
    for w, t in zip(rest_w, rest_t):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(w))
        assert np.asarray(t).dtype == np.asarray(w).dtype


def _load_both(name, path, monkeypatch, **kw):
    monkeypatch.chdir(path)
    kw = dict(dict(seed=0, labelrate_train=5, labelrate_val=5, split_idx=0),
              **kw)
    return (jds.load_data(name, ".", **kw), tds.load_data(name, ".", **kw))


# --------------------------------------------------------------------
# CPF
# --------------------------------------------------------------------

def _cpf_graph(rs, n=150, comps=(4, 3, 2, 2)):
    """A directed, weighted adjacency with one large component and a few
    small ones, some self-loops and some one-way edges."""
    big = n - sum(comps)
    rows, cols = [], []
    perm = rs.permutation(big)
    for i in range(1, big):                    # a random spanning tree
        rows.append(perm[i])
        cols.append(perm[rs.randint(i)])
    extra = rs.randint(0, big, (2, 3 * big))
    rows += extra[0].tolist()
    cols += extra[1].tolist()
    start = big
    for c in comps:                            # small components: paths
        for i in range(c - 1):
            rows.append(start + i)
            cols.append(start + i + 1)
        start += c
    rows += [0, 5, big]                        # self-loops
    cols += [0, 5, big]
    vals = rs.rand(len(rows)) + 0.5
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _write_cpf(path, rs, attr_kind, label_kind, n=150, classes=4):
    adj = _cpf_graph(rs, n)
    out = {"adj_data": adj.data, "adj_indices": adj.indices,
           "adj_indptr": adj.indptr, "adj_shape": np.array(adj.shape)}
    counts = rs.poisson(0.3, (n, 40)).astype(np.float32)
    if attr_kind == "csr":
        a = sp.csr_matrix(counts)
        out.update(attr_data=a.data, attr_indices=a.indices,
                   attr_indptr=a.indptr, attr_shape=np.array(a.shape))
    else:
        out["attr_matrix"] = rs.randn(n, 12).astype(np.float32)
    labels = rs.randint(0, classes, n)
    if label_kind == "dense":
        out["labels"] = labels
    else:
        # multilabel CSR; the rows of two labels lie in the small components,
        # which standardize drops: the per-class split (both packages check
        # that every class gets the same count) needs one label a node
        multi = np.zeros((n, classes))
        multi[np.arange(n), labels] = 1
        multi[np.arange(n - 6, n), rs.randint(0, classes, 6)] = 1
        lab = sp.csr_matrix(multi)
        out.update(labels_data=lab.data, labels_indices=lab.indices,
                   labels_indptr=lab.indptr, labels_shape=np.array(lab.shape))
    np.savez(path, **out)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("attr_kind,label_kind", [
    ("csr", "dense"), ("dense", "dense"), ("csr", "multilabel")])
def test_cpf_same_as_jax(tmp_path, monkeypatch, attr_kind, label_kind, seed):
    _write_cpf(tmp_path / "cora.npz", np.random.RandomState(seed + 10),
               attr_kind, label_kind)
    want, got = _load_both("cora", tmp_path, monkeypatch, seed=seed)
    _same(want, got)
    g = got[0]
    assert g.n_nodes == 150 - 11                   # the small components go
    assert (g.src == g.dst).sum() == g.n_nodes     # the pattern's self-loops
    assert len(got[2]) == 5 * 4 and len(got[3]) == 5 * 4


def test_cpf_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for load in (jds.load_data, tds.load_data):
        with pytest.raises(ValueError, match="citeseer.npz"):
            load("citeseer", ".", seed=0, labelrate_train=5, labelrate_val=5)


# --------------------------------------------------------------------
# OGB
# --------------------------------------------------------------------

def _write_ogb(path, rs, n=60, e=300, f=8, classes=5, dtype=np.int64):
    np.savez(path, src=rs.randint(0, n, e).astype(dtype),
             dst=rs.randint(0, n, e).astype(dtype), n_nodes=np.int64(n),
             feat=rs.randn(n, f).astype(np.float32),
             labels=rs.randint(0, classes, n).astype(np.int64),
             idx_train=rs.permutation(n)[:30],
             idx_val=np.arange(30, 45), idx_test=np.arange(45, n))


@pytest.mark.parametrize("name,dtype", [("ogbn-arxiv", np.int64),
                                        ("ogbn-products", np.int32)])
def test_ogb_same_as_jax(tmp_path, monkeypatch, name, dtype):
    _write_ogb(tmp_path / f"{name}.graph.npz", np.random.RandomState(1),
               dtype=dtype)
    want, got = _load_both(name, tmp_path, monkeypatch)
    _same(want, got)
    g = got[0]
    if name == "ogbn-arxiv":        # reversed edges, one self-loop a node
        assert (g.src == g.dst).sum() == 60
    else:                           # as it ships
        assert g.num_edges() == 300


def test_ogb_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for load in (jds.load_data, tds.load_data):
        with pytest.raises(ValueError, match="ogbn-products.graph.npz"):
            load("ogbn-products", ".")


# --------------------------------------------------------------------
# NonHom
# --------------------------------------------------------------------

def _write_splits(path, name, n, rs, labelled=None, k=5):
    pool = np.arange(n) if labelled is None else labelled
    splits = []
    for _ in range(k):
        p = rs.permutation(pool)
        a, b = len(p) // 2, 3 * len(p) // 4
        splits.append({"train": p[:a], "valid": p[a:b], "test": p[b:]})
    (path / "splits").mkdir(exist_ok=True)
    np.save(path / "splits" / f"{name}-splits.npy",
            np.array(splits, dtype=object), allow_pickle=True)


def _write_penn94(path, rs, n=80):
    a = sp.random(n, n, 0.08, random_state=rs, format="csr")   # asymmetric
    a.data[:] = 1.0
    a = a + sp.eye(n, format="csr")                             # self-loops
    info = np.stack([
        rs.randint(1, 4, n),          # status: 3 values
        rs.randint(0, 3, n),          # gender 0/1/2: labels -1/0/1
        rs.randint(0, 7, n),          # major: 7 values
        rs.choice([1999, 2004], n),   # binary: one 0/1 column
        rs.randint(0, 5, n),
        np.full(n, 3),                # one value: one column
        rs.randint(10, 40, n),
    ], axis=1)
    scipy.io.savemat(path / "penn94.mat", {"A": a.tocsc(), "local_info": info})
    _write_splits(path, "penn94", n, rs, labelled=np.where(info[:, 1] > 0)[0])


def test_penn94_same_as_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(4)
    _write_penn94(tmp_path, rs)
    want, got = _load_both("penn94", tmp_path, monkeypatch, split_idx=2)
    _same(want, got)
    g, labels, itr, iva, ite = got
    assert set(np.unique(labels)) <= {-1, 0, 1}
    assert (labels[np.concatenate([itr, iva, ite])] >= 0).all()
    pairs = set(zip(g.src.tolist(), g.dst.tolist()))
    assert all((b, a) in pairs for a, b in pairs)           # symmetrised


def _write_pokec(path, rs, n=70, e=200, f=6):
    ei = rs.randint(0, n, (2, e))
    scipy.io.savemat(path / "pokec.mat", {
        "edge_index": ei, "node_feat": rs.randn(n, f).astype(np.float32),
        "label": rs.randint(0, 2, (1, n))})
    _write_splits(path, "pokec", n, rs)


@pytest.mark.parametrize("split_idx", range(5))
def test_pokec_same_as_jax(tmp_path, monkeypatch, split_idx):
    _write_pokec(tmp_path, np.random.RandomState(5))
    want, got = _load_both("pokec", tmp_path, monkeypatch,
                           split_idx=split_idx)
    _same(want, got)
    split = tds.load_fixed_splits("pokec", tmp_path / "splits" /
                                  "pokec-splits.npy", split_idx)
    np.testing.assert_array_equal(split["valid"], got[3])


def test_nonhom_missing_files_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="pokec.mat"):
        tds.load_data("pokec", ".", split_idx=0)
    _write_pokec(tmp_path, np.random.RandomState(6))
    (tmp_path / "splits" / "pokec-splits.npy").unlink()
    with pytest.raises(ValueError, match="pokec-splits.npy"):
        tds.load_data("pokec", ".", split_idx=0)


# --------------------------------------------------------------------
# BGNN
# --------------------------------------------------------------------

def _write_bgnn(path, rs, n=90, y_float=False):
    """X.csv with an int, a float-with-NaN, a categorical-with-NaN, a
    numeric categorical, a constant and an all-NaN-in-train column (written
    by hand, as pandas' to_csv writes them), y, masks, graph."""
    d = path / "house_class"
    d.mkdir()
    train = rs.permutation(n)[:40]             # unsorted, as masks may be
    rest = np.setdiff1d(np.arange(n), train)
    cols = {
        "year": rs.randint(1950, 2020, n).astype(str),
        "area": np.array([repr(float(v)) for v in rs.randn(n) * 123.456]),
        "kind": rs.choice(["a", "b", "c", "dd"], n),
        "zone": rs.randint(0, 4, n).astype(str),
        "const": np.full(n, "7"),
        "sparse": np.array([repr(float(v)) for v in rs.rand(n)]),
    }
    cols["area"][rs.rand(n) < 0.1] = ""
    cols["kind"][rs.rand(n) < 0.15] = ""
    cols["sparse"][train] = ""
    with open(d / "X.csv", "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(n):
            f.write(",".join(c[i] for c in cols.values()) + "\n")
    y = rs.randint(0, 3, n)
    with open(d / "y.csv", "w") as f:
        f.write("class\n" + "".join(
            f"{v}.0\n" if y_float else f"{v}\n" for v in y))
    masks = {str(k): {"train": np.roll(train, k).tolist(),
                      "val": rest[: len(rest) // 2].tolist(),
                      "test": rest[len(rest) // 2:].tolist()}
             for k in range(2)}
    (d / "masks.json").write_text(json.dumps(masks))
    (d / "cat_features.txt").write_text("kind\nzone\nmissing_col\n")
    np.savez(d / "graph.npz", src=rs.randint(0, n, 300),
             dst=rs.randint(0, n, 300))


@pytest.mark.parametrize("split_idx,y_float", [(0, False), (1, True)])
def test_bgnn_same_as_jax(tmp_path, monkeypatch, split_idx, y_float):
    pytest.importorskip("pandas")
    pytest.importorskip("sklearn")
    _write_bgnn(tmp_path, np.random.RandomState(7), y_float=y_float)
    want, got = _load_both("house_class", tmp_path, monkeypatch,
                           split_idx=split_idx)
    _same(want, got)
    feat = got[0].ndata["feat"]
    assert feat.shape == (90, 6)
    assert np.isnan(feat[:, 5]).all()          # no train value: stays NaN
    assert np.isfinite(feat[:, :5]).all()
    np.testing.assert_array_equal(feat[:, 4], 0.0)    # constant: scale 1


def test_read_csv_types_as_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    text = ("a,b,c,d,e,,g\n1,2.5,x,True,+3,7,NA\n"
            "2,,y,False,-4,8,1e3\n\n3,1e-3,,True,5,9,-inf\n")
    (tmp_path / "t.csv").write_text(text)
    got = tds.read_csv(tmp_path / "t.csv")
    want = pd.read_csv(tmp_path / "t.csv")
    assert list(got) == list(want.columns)
    for name, col in got.items():
        w = want[name]
        if w.dtype.kind in "iufb":
            assert col.dtype == w.dtype, name
            np.testing.assert_array_equal(col, w.to_numpy())
        else:
            assert col.dtype == object
            assert [v if v == v else None for v in col] == [
                v if v == v else None for v in w.to_numpy(object)]


def test_catboost_encoding_kahan_sums_as_pandas():
    """Non-integer targets: the Kahan-compensated running sums give the
    JAX package's (pandas groupby) codes bit for bit."""
    pd = pytest.importorskip("pandas")
    rs = np.random.RandomState(8)
    n = 200
    cats = rs.choice(["p", "q", "r"], n).astype(object)
    cats[rs.rand(n) < 0.1] = np.nan
    y = rs.randn(n) * 1e3 + 1e-7 * rs.rand(n)
    train = rs.permutation(n)[:150]
    want = jds.encode_cat_features(pd.DataFrame({"c": cats}),
                                   pd.DataFrame({"y": y}), ["c"], train)
    got = tds.encode_cat_features({"c": cats}, y, ["c"], train)
    np.testing.assert_array_equal(got["c"], want["c"].to_numpy())


def test_bgnn_string_column_not_listed_raises(tmp_path, monkeypatch):
    _write_bgnn(tmp_path, np.random.RandomState(9))
    (tmp_path / "house_class" / "cat_features.txt").write_text("zone\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="'kind'"):
        tds.load_data("house_class", ".", split_idx=0)


def test_loaders_need_no_pandas_sklearn_or_ogb(tmp_path, monkeypatch):
    """In a process where `import pandas`, `import sklearn` and `import ogb`
    fail, every family loads, and BGNN gives the JAX package's arrays."""
    pytest.importorskip("pandas")
    rs = np.random.RandomState(11)
    _write_bgnn(tmp_path, rs)
    _write_cpf(tmp_path / "cora.npz", rs, "csr", "dense")
    _write_ogb(tmp_path / "ogbn-arxiv.graph.npz", rs)
    _write_penn94(tmp_path, rs)
    _write_pokec(tmp_path, rs)
    monkeypatch.chdir(tmp_path)
    g, *rest = jds.load_data("house_class", ".", split_idx=0)
    np.savez(tmp_path / "want.npz", src=g.src, dst=g.dst,
             feat=np.asarray(g.ndata["feat"]), labels=rest[0],
             train=rest[1], val=rest[2], test=rest[3])
    code = """
import sys
for name in ("pandas", "sklearn", "ogb"):
    sys.modules[name] = None
import numpy as np
from glnn_tpu_torch.graph.datasets import load_data
g, labels, itr, iva, ite = load_data("house_class", ".", split_idx=0)
w = np.load("want.npz")
for got, key in ((g.src, "src"), (g.dst, "dst"), (g.ndata["feat"], "feat"),
                 (labels, "labels"), (itr, "train"), (iva, "val"),
                 (ite, "test")):
    np.testing.assert_array_equal(got, w[key], err_msg=key)
for name in ("cora", "ogbn-arxiv", "penn94", "pokec"):
    load_data(name, ".", seed=0, labelrate_train=5, labelrate_val=5,
              split_idx=0)
bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", "sklearn",
                                                     "ogb")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_dataset_modules_import_no_pandas_sklearn_or_ogb():
    for path in ("graph/datasets.py", "graph/sparse.py", "graph/host.py"):
        text = (REPO / "glnn_tpu_torch" / path).read_text()
        for name in ("pandas", "sklearn", "ogb"):
            assert f"import {name}" not in text and f"from {name}" not in text


# --------------------------------------------------------------------
# sparse.py and host.py against glnn_tpu
# --------------------------------------------------------------------

def _host_pair(rs, n=60, e=150):
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    src[:4] = dst[:4]                                   # self-loops
    jg, tg = jhost.HostGraph(src, dst, n), thost.HostGraph(src, dst, n)
    feat = rs.randn(n, 3).astype(np.float32)
    jg.ndata["feat"], tg.ndata["feat"] = feat, feat
    return jg, tg


def _same_graph(jg, tg):
    assert jg.n_nodes == tg.n_nodes
    np.testing.assert_array_equal(tg.src, jg.src)
    np.testing.assert_array_equal(tg.dst, jg.dst)
    np.testing.assert_array_equal(tg.ndata["feat"], jg.ndata["feat"])


@pytest.mark.parametrize("op", ["add_reverse_edges", "remove_self_loop",
                                "add_self_loop", "to_bidirected"])
def test_host_edge_surgery_same_as_jax(op, tier):
    jg, tg = _host_pair(np.random.RandomState(12))
    _same_graph(getattr(jg, op)(), getattr(tg, op)())


def test_host_queries_same_as_jax(tier):
    jg, tg = _host_pair(np.random.RandomState(13))
    assert tg.num_nodes() == jg.num_nodes() == 60
    for name in ("in_degrees", "out_degrees"):
        np.testing.assert_array_equal(getattr(tg, name)(),
                                      getattr(jg, name)())
    for name in ("csr", "csc"):
        for a, b in zip(getattr(tg, name)(), getattr(jg, name)()):
            np.testing.assert_array_equal(a, b)
    assert (tg.adj_scipy() != jg.adj_scipy()).nnz == 0


def test_largest_connected_component_same_as_jax(tier):
    rs = np.random.RandomState(14)
    adj = _cpf_graph(rs, 90, comps=(5, 3, 3)).tocoo()
    jg = jhost.HostGraph(adj.row, adj.col, 90)
    tg = thost.HostGraph(adj.row, adj.col, 90)
    got = thost.largest_connected_component(tg)
    np.testing.assert_array_equal(got, jhost.largest_connected_component(jg))
    assert len(got) == 90 - 11
    np.testing.assert_array_equal(
        thost.largest_connected_component(tg.subgraph(got)),
        np.arange(len(got)))
    k, comp = thost.connected_components(tg.src, tg.dst, 90)
    assert k == 4 and comp.dtype == np.int64


def test_rcm_and_reorder_same_as_jax():
    jg, tg = _host_pair(np.random.RandomState(15))
    order = thost.rcm_ordering(tg)
    np.testing.assert_array_equal(order, jhost.rcm_ordering(jg))
    assert sorted(order.tolist()) == list(range(60))
    _same_graph(jhost.reorder_nodes(jg, order), thost.reorder_nodes(tg, order))


def test_create_subgraph_same_as_jax():
    rs = np.random.RandomState(16)
    adj = sp.random(12, 12, 0.3, random_state=rs, format="csr")
    attr, labels = rs.randn(12, 3), rs.randint(0, 3, 12)
    for mod in (jsp, tsp):
        with pytest.raises(ValueError, match="Either"):
            mod.create_subgraph(adj, attr, labels)
        with pytest.raises(ValueError, match="Only one"):
            mod.create_subgraph(adj, attr, labels, nodes_to_remove=[0],
                                nodes_to_keep=[1])
    for kw in (dict(nodes_to_remove=[3, 0, 7]), dict(nodes_to_keep=[9, 2, 5])):
        wa, wx, wl = jsp.create_subgraph(adj, attr, labels, **kw)
        ga, gx, gl = tsp.create_subgraph(adj, attr, labels, **kw)
        assert (ga != wa).nnz == 0
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gl, wl)


def test_sparse_helpers_same_as_jax():
    rs = np.random.RandomState(17)
    labels = np.repeat(np.arange(5), [3, 30, 12, 50, 9])
    for rates in ((0.1, 0.1), (0.3, 0.4)):
        np.testing.assert_array_equal(
            tsp.remove_underrepresented_classes(labels, *rates),
            jsp.remove_underrepresented_classes(labels, *rates))
    for lab in (rs.randint(3, 9, 20), sp.csr_matrix(rs.rand(20, 4) < 0.3)):
        for a, b in zip(tsp.binarize_labels(lab, return_classes=True),
                        jsp.binarize_labels(lab, return_classes=True)):
            np.testing.assert_array_equal(a, b)
    adj = _cpf_graph(rs, 40, comps=(2,))
    for name in ("to_unweighted", "to_undirected", "eliminate_self_loops",
                 "normalize_adj"):
        got, want = getattr(tsp, name)(adj), getattr(jsp, name)(adj)
        assert abs(got - want).max() == 0
    np.testing.assert_array_equal(tsp.largest_connected_component_nodes(adj),
                                  jsp.largest_connected_component_nodes(adj))
    counts = rs.poisson(0.7, (6, 5)).astype(np.float64)
    for f in (counts, sp.csr_matrix(counts)):
        b = tsp.to_binary_bag_of_words(f)
        assert tsp.is_binary_bag_of_words(b) and jsp.is_binary_bag_of_words(b)
        assert tsp.is_binary_bag_of_words(f) == jsp.is_binary_bag_of_words(f)
        assert abs(sp.csr_matrix(b) - sp.csr_matrix(
            jsp.to_binary_bag_of_words(f))).max() == 0


def test_npz_round_trip(tmp_path):
    rs = np.random.RandomState(18)
    adj = _cpf_graph(rs, 30, comps=(2,))
    attr = sp.csr_matrix(rs.poisson(0.5, (30, 7)).astype(np.float32))
    labels = rs.randint(0, 3, 30)
    tsp.save_npz_sparse_graph(tmp_path / "g.npz", adj, attr, labels)
    got = tsp.load_npz_sparse_graph(tmp_path / "g.npz")
    want = jsp.load_npz_sparse_graph(tmp_path / "g.npz")
    assert (got[0] != adj).nnz == 0 and (got[0] != want[0]).nnz == 0
    assert (got[1] != attr).nnz == 0
    np.testing.assert_array_equal(got[2], labels)


# --------------------------------------------------------------------
# Both CLIs on tiny dataset files
# --------------------------------------------------------------------

@pytest.mark.parametrize("dataset,teacher", [("cora", "GCN"),
                                             ("ogbn-arxiv", "SAGE")])
def test_cli_teacher_then_student(tmp_path, monkeypatch, capsys, dataset,
                                  teacher):
    from glnn_tpu_torch.cli import train_student, train_teacher

    rs = np.random.RandomState(19)
    data = tmp_path / "data"
    data.mkdir()
    if dataset == "cora":
        _write_cpf(data / "cora.npz", rs, "csr", "dense", n=300, classes=3)
    else:
        _write_ogb(data / "ogbn-arxiv.graph.npz", rs, n=200, e=900, f=16)
    monkeypatch.chdir(tmp_path)
    common = ["--device", "-1", "--dataset", dataset, "--data_path", "data",
              "--max_epoch", "3", "--labelrate_train", "10",
              "--labelrate_val", "10", "--teacher", teacher]
    train_teacher.main(common)
    train_student.main(common + ["--student", "MLP"])
    g, labels, *_ = tds.load_data(dataset, "data", seed=0, labelrate_train=10,
                                  labelrate_val=10)
    for model in (teacher, f"{teacher}_MLP"):
        out = np.load(tmp_path / "outputs" / "transductive" / dataset / model
                      / "seed_0" / "out.npz")["arr_0"]
        assert out.shape == (g.n_nodes, labels.max() + 1)
        np.testing.assert_allclose(np.exp(out).sum(1), 1.0, rtol=1e-4)
    scores = [float(v) for v in capsys.readouterr().out.split()]
    assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)
