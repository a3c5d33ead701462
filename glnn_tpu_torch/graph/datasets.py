"""Dataset loading: `load_data(dataset, path, **kw) -> (HostGraph, labels,
idx_train, idx_val, idx_test)`, as `glnn_tpu/graph/datasets.py`.

Ported: the offline `synth-*` planted-partition family
(`synth[-<key><val>...]`, e.g. `synth-n169343-c40-f128-d7`), built with the
same numpy calls as the JAX package, so both give identical graphs,
features, labels and splits. The CPF, OGB, NonHom and BGNN loaders are not
ported yet (ROADMAP queue A item 5) and raise.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from glnn_tpu_torch.graph import sparse as gsp
from glnn_tpu_torch.graph.host import HostGraph
from glnn_tpu_torch.utils.common import (
    BGNN_data, CPF_data, NonHom_data, OGB_data, SYNTH_prefix,
)
from glnn_tpu_torch.utils.splits import get_train_val_test_split


def load_data(dataset: str, dataset_path: str, **kwargs):
    for family, names in (("CPF", CPF_data), ("OGB", OGB_data),
                          ("NonHom", NonHom_data), ("BGNN", BGNN_data)):
        if dataset in names:
            raise NotImplementedError(
                f"the {family} loader ({dataset}) is not ported to "
                "glnn_tpu_torch yet (ROADMAP queue A item 5); use a "
                "synth-* dataset or the glnn_tpu package")
    if dataset.startswith(SYNTH_prefix):
        return load_synth_data(
            dataset, kwargs.get("seed", 0),
            kwargs.get("labelrate_train", 20), kwargs.get("labelrate_val", 30),
        )
    raise ValueError(f"Unknown dataset: {dataset}")


def load_out_t(out_t_dir):
    """Teacher log-probs from the `out.npz` teacher->student handoff."""
    return np.load(Path(out_t_dir).joinpath("out.npz"))["arr_0"]


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
