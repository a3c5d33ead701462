"""Dataset loading: `load_data(dataset, path, **kw) -> (HostGraph, labels,
idx_train, idx_val, idx_test)`, the dispatch of `glnn_tpu/graph/datasets.py`
over every dataset family, giving the same arrays:

* CPF (cora, citeseer, pubmed, a-computer, a-photo): `<path>/<name>.npz` in
  the CPF schema; `standardize`, the per-class labelrate split from
  `RandomState(seed)`, and the pattern of D^-1(A + I) as the edge set
  (self-loops enter it, the weights are dropped).
* OGB (ogbn-arxiv, ogbn-products): the pre-converted
  `<path>/<name>.graph.npz` (keys src, dst, n_nodes, feat, labels,
  idx_train, idx_val, idx_test), which `tools/convert_datasets.py` writes
  on a machine with the `ogb` package; the port never imports `ogb`.
  ogbn-arxiv gains reversed edges, then loses and regains its self-loops;
  ogbn-products is used as it ships.
* NonHom (penn94, pokec): `<path>/<name>.mat` and the fixed splits
  `<path>/splits/<name>-splits.npy`, `split_idx` selecting one.
* BGNN (house_class, vk_class): `<path>/<name>/` with X.csv, y.csv,
  masks.json, graph.npz and an optional cat_features.txt; read with the
  `csv` module and numpy (no pandas, no sklearn), with pandas' type
  inference, CatBoost ordered-target encoding of the categorical columns,
  MinMaxScaler's arithmetic fitted on the train rows, and NaN replaced by
  the train rows' minimum minus one.
* synth (`synth[-<key><val>...]`, e.g. `synth-n169343-c40-f128-d7`): the
  offline planted-partition family, built with the same numpy calls as the
  JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import re
import warnings
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from glnn_tpu_torch.graph import sparse as gsp
from glnn_tpu_torch.graph.host import HostGraph
from glnn_tpu_torch.utils.common import (
    BGNN_data, CPF_data, NonHom_data, OGB_data, SYNTH_prefix,
)
from glnn_tpu_torch.utils.splits import get_train_val_test_split


def load_data(dataset: str, dataset_path: str, **kwargs):
    if dataset in CPF_data:
        return load_cpf_data(
            dataset, dataset_path, kwargs["seed"],
            kwargs["labelrate_train"], kwargs["labelrate_val"],
        )
    if dataset in OGB_data:
        return load_ogb_data(dataset, dataset_path)
    if dataset in NonHom_data:
        return load_nonhom_data(dataset, dataset_path, kwargs["split_idx"])
    if dataset in BGNN_data:
        return load_bgnn_data(dataset, dataset_path, kwargs["split_idx"])
    if dataset.startswith(SYNTH_prefix):
        return load_synth_data(
            dataset, kwargs.get("seed", 0),
            kwargs.get("labelrate_train", 20), kwargs.get("labelrate_val", 30),
        )
    raise ValueError(f"Unknown dataset: {dataset}")


def load_out_t(out_t_dir):
    """Teacher log-probs from the `out.npz` teacher->student handoff."""
    return np.load(Path(out_t_dir).joinpath("out.npz"))["arr_0"]


# --------------------------------------------------------------------
# CPF
# --------------------------------------------------------------------

def load_cpf_data(dataset, dataset_path, seed, labelrate_train, labelrate_val):
    data_path = Path.cwd().joinpath(dataset_path, f"{dataset}.npz")
    if not os.path.isfile(data_path):
        raise ValueError(f"{data_path} doesn't exist.")
    adj, attr, labels = gsp.load_npz_sparse_graph(data_path)
    adj, attr, labels = gsp.standardize(adj, attr, labels)

    labels_onehot = gsp.binarize_labels(labels)
    rs = np.random.RandomState(seed)
    idx_train, idx_val, idx_test = get_train_val_test_split(
        rs, labels_onehot, labelrate_train, labelrate_val
    )
    features = np.asarray(attr.todense() if sp.issparse(attr) else attr,
                          np.float32)
    labels = labels_onehot.argmax(axis=1).astype(np.int64)

    # only the pattern of D^-1(A + I): the self-loops enter the edge set and
    # the row-normalised weights are dropped, as the reference's
    # dgl.graph((row, col)) drops them
    pat = gsp.normalize_adj(adj).tocoo()
    g = HostGraph(pat.row.astype(np.int64), pat.col.astype(np.int64),
                  adj.shape[0])
    g.ndata["feat"] = features
    return g, labels, idx_train, idx_val, idx_test


# --------------------------------------------------------------------
# OGB
# --------------------------------------------------------------------

def load_ogb_data(dataset, dataset_path):
    pre = Path.cwd().joinpath(dataset_path, f"{dataset}.graph.npz")
    if not os.path.isfile(pre):
        raise ValueError(
            f"{pre} not found: glnn_tpu_torch reads OGB datasets from this "
            f"pre-converted file only; tools/convert_datasets.py writes it "
            f"on a machine with the `ogb` package.")
    with np.load(pre) as d:
        g = HostGraph(d["src"], d["dst"], int(d["n_nodes"]))
        g.ndata["feat"] = d["feat"].astype(np.float32)
        labels = d["labels"].astype(np.int64)
        idx_train, idx_val, idx_test = (np.asarray(d[k]) for k in (
            "idx_train", "idx_val", "idx_test"))
    if dataset == "ogbn-arxiv":
        g = g.add_reverse_edges().remove_self_loop().add_self_loop()
    return g, labels, idx_train, idx_val, idx_test


# --------------------------------------------------------------------
# NonHom (penn94 / pokec)
# --------------------------------------------------------------------

def load_nonhom_data(dataset, dataset_path, split_idx):
    data_path = Path.cwd().joinpath(dataset_path, f"{dataset}.mat")
    split_path = Path.cwd().joinpath(dataset_path, "splits",
                                     f"{dataset}-splits.npy")
    if dataset == "pokec":
        g, features, labels = _load_pokec_mat(data_path)
    elif dataset == "penn94":
        g, features, labels = _load_penn94_mat(data_path)
    else:
        raise ValueError("Invalid dataname")

    g = g.remove_self_loop().add_self_loop()
    g.ndata["feat"] = features
    labels = np.asarray(labels, np.int64)

    splits = load_fixed_splits(dataset, split_path, split_idx)
    return g, labels, splits["train"], splits["valid"], splits["test"]


def _load_penn94_mat(data_path):
    """penn94 (facebook100): the symmetrised A; features one-hot of every
    local_info column but gender (col 1), a column of exactly two values as
    one 0/1 column (as sklearn's label_binarize gives it), k columns for k
    values otherwise; label = gender - 1 (unlabelled: -1)."""
    import scipy.io

    mat = scipy.io.loadmat(str(data_path))
    A = mat["A"].tocsr().tocoo()
    metadata = mat["local_info"].astype(np.int64)
    g = HostGraph(A.row.astype(np.int64), A.col.astype(np.int64),
                  A.shape[0]).to_bidirected()
    labels = metadata[:, 1] - 1

    feature_vals = np.hstack((metadata[:, :1], metadata[:, 2:]))
    features = []
    for col in range(feature_vals.shape[1]):
        feat_col = feature_vals[:, col]
        classes = np.unique(feat_col)
        if len(classes) == 2:
            features.append((feat_col == classes[1]).astype(
                np.float32)[:, None])
        else:
            features.append(gsp.binarize_labels(feat_col))
    return g, np.hstack(features).astype(np.float32), labels


def _load_pokec_mat(data_path):
    import scipy.io

    if not os.path.isfile(data_path):
        raise ValueError(
            f"{data_path} doesn't exist: tools/fetch_pokec.py fetches it on "
            f"a machine with network access.")
    mat = scipy.io.loadmat(str(data_path))
    edge_index = np.asarray(mat["edge_index"], np.int64)
    features = np.asarray(mat["node_feat"], np.float32)
    labels = np.asarray(mat["label"], np.int64).ravel()
    g = HostGraph(edge_index[0], edge_index[1],
                  features.shape[0]).to_bidirected()
    return g, features, labels


def load_fixed_splits(dataset, split_path, split_idx):
    """Split `split_idx` of the pre-generated fixed splits (a pickled array
    of dicts with train, valid and test index arrays)."""
    if not os.path.exists(split_path):
        raise ValueError(f"split file {split_path} not found")
    split = np.load(split_path, allow_pickle=True)[split_idx]
    return {k: np.asarray(split[k]).ravel()
            for k in ("train", "valid", "test")}


# --------------------------------------------------------------------
# BGNN (house_class / vk_class)
# --------------------------------------------------------------------

# the strings pandas.read_csv reads as missing by default
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|inf|infinity)\s*", re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def _parse_column(fields):
    """One CSV column as pandas.read_csv types it: int64 when every field is
    an integer; float64 (missing as NaN) when every present field is a
    number; bool when every field is a boolean word (with a missing field:
    float64 1/0/NaN, what pandas' object column becomes as float64); else
    an object array of the strings, missing as NaN."""
    present = [f for f in fields if f not in _NA_STRINGS]
    missing = len(present) < len(fields)
    if not missing and all(_INT.fullmatch(f) for f in present):
        return np.array([int(f) for f in fields], np.int64)
    if all(_INT.fullmatch(f) or _FLOAT.fullmatch(f) for f in present):
        return np.array([math.nan if f in _NA_STRINGS else float(f)
                         for f in fields], np.float64)
    if all(f in _BOOL for f in present):
        if not missing:
            return np.array([_BOOL[f] for f in fields], bool)
        return np.array([math.nan if f in _NA_STRINGS else float(_BOOL[f])
                         for f in fields], np.float64)
    return np.array([math.nan if f in _NA_STRINGS else f for f in fields],
                    object)


def read_csv(path) -> dict:
    """{column name: typed numpy column} of a CSV with a header row, typed
    as pandas.read_csv types it (`_parse_column`); blank lines are skipped
    and a column with an empty name is called "Unnamed: <position>"."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    for r in body:
        if len(r) != len(header):
            raise ValueError(f"{path}: a row of {len(r)} fields under a "
                             f"header of {len(header)}")
    names = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
    return {name: _parse_column([r[i] for r in body])
            for i, name in enumerate(names)}


def load_bgnn_data(dataset, dataset_path, split_idx):
    data_path = Path.cwd().joinpath(dataset_path, f"{dataset}")
    X = read_csv(data_path.joinpath("X.csv"))
    y = np.stack(list(read_csv(data_path.joinpath("y.csv")).values()),
                 axis=1)
    with open(data_path.joinpath("masks.json")) as f:
        masks = json.load(f)
    categorical_columns = []
    if os.path.exists(data_path.joinpath("cat_features.txt")):
        with open(data_path.joinpath("cat_features.txt")) as f:
            categorical_columns = [line.strip() for line in f if line.strip()]
    with np.load(data_path.joinpath("graph.npz")) as edges:
        src = edges["src"].astype(np.int64)
        dst = edges["dst"].astype(np.int64)

    train_mask = np.asarray(masks[str(split_idx)]["train"], np.int64)
    val_mask = np.asarray(masks[str(split_idx)]["val"], np.int64)
    test_mask = np.asarray(masks[str(split_idx)]["test"], np.int64)

    cat_features = [c for c in categorical_columns if c in X]
    if cat_features:
        X = encode_cat_features(X, y, cat_features, train_mask)
    features = replace_na(normalize_features(X, train_mask), train_mask)
    features = features.astype(np.float32)
    labels = y.ravel().astype(np.int64)

    g = HostGraph(src, dst,
                  features.shape[0]).remove_self_loop().add_self_loop()
    g.ndata["feat"] = features
    return g, labels, train_mask, val_mask, test_mask


_NAN_CATEGORY = object()     # a missing category is a category of its own


def encode_cat_features(X: dict, y, cat_features, train_mask) -> dict:
    """CatBoost ordered-target encoding (category_encoders' CatBoostEncoder,
    a = 1, no noise) of the columns `cat_features` of X:

    * train rows, in the order of the train index list: (prior + sum of y
      over the category's earlier train rows) / (1 + their count), the row's
      own label left out;
    * other rows: (prior + the category's train sum) / (1 + its train
      count); a category unseen in train gives the prior;
    * prior = the mean of y over the train rows.

    The running sums are Kahan-compensated, as pandas' groupby cumsum and
    sum compute them, so the codes equal the JAX package's bit for bit.
    """
    X = dict(X)
    y = np.asarray(y, np.float64).ravel()
    train_idx = np.asarray(train_mask)
    if train_idx.dtype == bool:
        train_idx = np.where(train_idx)[0]
    prior = y[train_idx].mean()
    n = len(next(iter(X.values())))
    rest_idx = np.setdiff1d(np.arange(n), train_idx)
    for col in cat_features:
        keys = [_NAN_CATEGORY if v != v else v for v in X[col].tolist()]
        total, comp, count = {}, {}, {}
        enc = np.empty(n, np.float64)
        for i in train_idx.tolist():
            k, val = keys[i], float(y[i])
            acc, c, m = total.get(k, 0.0), comp.get(k, 0.0), count.get(k, 0)
            step = val - c
            t = acc + step
            comp[k], total[k], count[k] = t - acc - step, t, m + 1
            enc[i] = (prior + (t - val)) / (1.0 + m)
        for i in rest_idx.tolist():
            k = keys[i]
            enc[i] = (prior + total.get(k, 0.0)) / (1.0 + count.get(k, 0))
        X[col] = enc
    return X


def normalize_features(X: dict, train_mask) -> np.ndarray:
    """The float64 [rows, columns] matrix of X min-max scaled with
    statistics of the train rows, in sklearn MinMaxScaler's arithmetic:
    scale = 1 / (max - min) (a range under 10 eps scales by 1),
    min_ = 0 - min * scale, then x * scale + min_ (NaN is ignored by the
    fit and stays NaN)."""
    cols = []
    for name, col in X.items():
        try:
            cols.append(np.asarray(col, np.float64))
        except ValueError as e:
            raise ValueError(f"BGNN column {name!r} holds strings and is not "
                             f"listed in cat_features.txt") from e
    M = np.stack(cols, axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN columns
        data_min = np.nanmin(M[train_mask], axis=0)
        data_max = np.nanmax(M[train_mask], axis=0)
    data_range = data_max - data_min
    data_range[data_range < 10 * np.finfo(np.float64).eps] = 1.0
    scale = 1.0 / data_range
    M *= scale
    M += 0.0 - data_min * scale
    return M


def replace_na(M: np.ndarray, train_mask) -> np.ndarray:
    """NaN -> the column's minimum over the train rows, minus 1 (a column
    with no train value stays NaN)."""
    nan = np.isnan(M)
    if nan.any():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fill = np.nanmin(M[train_mask], axis=0) - 1
        M = np.where(nan, fill[None, :], M)
    return M


# --------------------------------------------------------------------
# Synthetic planted-partition graphs (offline)
# --------------------------------------------------------------------

_SYNTH_DEFAULTS = dict(n=2048, c=7, f=128, d=10, p_in=0.8, noise=1.0)


def parse_synth_name(name: str) -> dict:
    """`synth-n2048-c7-f128-d10` -> params. Unknown tokens rejected."""
    params = dict(_SYNTH_DEFAULTS)
    if name == SYNTH_prefix:
        return params
    body = name[len(SYNTH_prefix):].lstrip("-")
    for tok in body.split("-"):
        m = re.fullmatch(r"([a-z_]+)([0-9.]+)", tok)
        if not m:
            raise ValueError(f"bad synth dataset token: {tok!r} in {name!r}")
        key, val = m.group(1), m.group(2)
        if key not in params:
            raise ValueError(f"unknown synth param {key!r}")
        params[key] = type(params[key])(float(val) if "." in val else int(val))
    return params


def make_synth_graph(n, c, f, d, p_in=0.8, noise=1.0, data_seed=42):
    """Deterministic planted-partition graph: round-robin classes, ~d
    neighbours per node (a p_in share within the class), features = class
    centroid + white noise."""
    rs = np.random.RandomState(data_seed)
    labels = np.arange(n, dtype=np.int64) % c
    class_members = [np.where(labels == k)[0] for k in range(c)]

    num_draws = n * d
    src = np.repeat(np.arange(n, dtype=np.int64), d)
    same = rs.rand(num_draws) < p_in
    class_sizes = np.array([len(m) for m in class_members])
    member_table = np.full((c, class_sizes.max()), -1, np.int64)
    for k in range(c):
        member_table[k, : class_sizes[k]] = class_members[k]
    pick = rs.randint(0, class_sizes[labels[src]])
    dst_same = member_table[labels[src], pick]
    dst_rand = rs.randint(0, n, size=num_draws)
    dst = np.where(same, dst_same, dst_rand)

    keep = src != dst
    g = HostGraph(src[keep], dst[keep], n).to_bidirected().add_self_loop()

    centroids = rs.randn(c, f).astype(np.float32) * 0.5
    feats = centroids[labels] + noise * rs.randn(n, f).astype(np.float32)
    g.ndata["feat"] = feats
    return g, labels


def load_synth_data(dataset, seed, labelrate_train, labelrate_val):
    p = parse_synth_name(dataset)
    g, labels = make_synth_graph(p["n"], p["c"], p["f"], p["d"],
                                 p["p_in"], p["noise"])
    onehot = gsp.binarize_labels(labels)
    rs = np.random.RandomState(seed)
    idx_train, idx_val, idx_test = get_train_val_test_split(
        rs, onehot, labelrate_train, labelrate_val
    )
    return g, labels, idx_train, idx_val, idx_test
