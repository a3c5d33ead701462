"""CPF-format sparse graph ingest and preprocessing
(`glnn_tpu/graph/sparse.py`).

A small functional layer over scipy.sparse, with the same numeric
contracts as the JAX package:

* `standardize` = unweighted -> undirected (max-symmetrise) -> no self
  loops -> largest connected component.
* `normalize_adj` row-normalises A + I; the CPF loader keeps only the
  sparsity pattern of the result (self-loops included, weights dropped).
* `binarize_labels` one-hot encodes integer labels; a multilabel CSR
  passes through as a dense binary matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def load_npz_sparse_graph(file_name):
    """Read the CPF npz schema -> (adj csr, attr matrix, labels).

    Keys: adj_{data,indices,indptr,shape}; attr_* as CSR triples or a dense
    `attr_matrix`; labels as CSR triples or a dense `labels`.
    """
    with np.load(file_name, allow_pickle=True) as loader:
        d = dict(loader)
    adj = sp.csr_matrix((d["adj_data"], d["adj_indices"], d["adj_indptr"]),
                        shape=d["adj_shape"])
    if "attr_data" in d:
        attr = sp.csr_matrix(
            (d["attr_data"], d["attr_indices"], d["attr_indptr"]),
            shape=d["attr_shape"],
        )
    elif "attr_matrix" in d:
        attr = d["attr_matrix"]
    else:
        attr = None
    if "labels_data" in d:
        labels = sp.csr_matrix(
            (d["labels_data"], d["labels_indices"], d["labels_indptr"]),
            shape=d["labels_shape"],
        )
    elif "labels" in d:
        labels = d["labels"]
    else:
        labels = None
    return adj, attr, labels


def save_npz_sparse_graph(file_name, adj: sp.csr_matrix, attr, labels):
    """Write the CPF npz schema (round-trips with load_npz_sparse_graph)."""
    adj = adj.tocsr()
    out = {
        "adj_data": adj.data,
        "adj_indices": adj.indices,
        "adj_indptr": adj.indptr,
        "adj_shape": np.array(adj.shape),
    }
    if sp.issparse(attr):
        a = attr.tocsr()
        out.update(
            attr_data=a.data, attr_indices=a.indices,
            attr_indptr=a.indptr, attr_shape=np.array(a.shape),
        )
    elif attr is not None:
        out["attr_matrix"] = np.asarray(attr)
    if labels is not None:
        out["labels"] = np.asarray(labels)
    np.savez(file_name, **out)


def to_unweighted(adj: sp.csr_matrix) -> sp.csr_matrix:
    adj = adj.copy()
    adj.data = np.ones_like(adj.data)
    return adj


def to_undirected(adj: sp.csr_matrix) -> sp.csr_matrix:
    return adj.maximum(adj.T)


def eliminate_self_loops(adj: sp.csr_matrix) -> sp.csr_matrix:
    adj = sp.lil_matrix(adj)
    adj.setdiag(0)
    adj = adj.tocsr()
    adj.eliminate_zeros()
    return adj


def largest_connected_component_nodes(adj: sp.csr_matrix) -> np.ndarray:
    _, labels = sp.csgraph.connected_components(adj, directed=False)
    sizes = np.bincount(labels)
    return np.where(labels == sizes.argmax())[0]


def standardize(adj, attr, labels):
    """unweighted + undirected + no self-loops + largest CC."""
    adj = eliminate_self_loops(to_undirected(to_unweighted(adj)))
    keep = largest_connected_component_nodes(adj)
    adj = adj[keep][:, keep]
    if attr is not None:
        attr = attr[keep]
    if labels is not None:
        labels = labels[keep]
    return adj, attr, labels


def normalize_adj(adj: sp.csr_matrix) -> sp.csr_matrix:
    """Row-normalise D^-1 (A + I)."""
    adj = adj + sp.eye(adj.shape[0], format="csr")
    deg = np.asarray(adj.sum(axis=1)).ravel()
    inv = np.divide(1.0, deg, out=np.zeros_like(deg, dtype=np.float64),
                    where=deg > 0)
    return sp.diags(inv) @ adj


def binarize_labels(labels, return_classes=False):
    """One-hot encode integer labels, one column per distinct label; a
    multilabel CSR passes through as a dense binary matrix. With
    `return_classes`, also the label of each column."""
    if sp.issparse(labels):
        out = np.asarray((labels > 0).todense()).astype(np.int64)
        classes = np.arange(out.shape[1])
    else:
        labels = np.asarray(labels).ravel()
        classes = np.unique(labels)
        out = np.zeros((labels.shape[0], classes.shape[0]), np.int64)
        out[np.arange(labels.shape[0]), np.searchsorted(classes, labels)] = 1
    if return_classes:
        return out, classes
    return out


def remove_underrepresented_classes(labels, train_rate, val_rate):
    """Mask of the nodes whose class has enough members for the per-class
    train/val sampling: count * (1 - train_rate - val_rate) > 8."""
    labels = np.asarray(labels).ravel()
    classes, counts = np.unique(labels, return_counts=True)
    ok = classes[counts * (1.0 - train_rate - val_rate) > 8]
    return np.isin(labels, ok)


def create_subgraph(adj, attr, labels, nodes_to_remove=None,
                    nodes_to_keep=None):
    """Node-subset subgraph; exactly one of nodes_to_remove / nodes_to_keep
    must be given. The kept nodes keep their relative order."""
    if nodes_to_remove is None and nodes_to_keep is None:
        raise ValueError("Either nodes_to_remove or nodes_to_keep must "
                         "be provided.")
    if nodes_to_remove is not None and nodes_to_keep is not None:
        raise ValueError("Only one of nodes_to_remove or nodes_to_keep "
                         "must be provided.")
    if nodes_to_remove is not None:
        nodes_to_keep = sorted(set(range(adj.shape[0]))
                               - set(np.asarray(nodes_to_remove).tolist()))
    else:
        nodes_to_keep = sorted(np.asarray(nodes_to_keep).tolist())
    nodes_to_keep = np.asarray(nodes_to_keep)
    adj = adj[nodes_to_keep][:, nodes_to_keep]
    if attr is not None:
        attr = attr[nodes_to_keep]
    if labels is not None:
        labels = labels[nodes_to_keep]
    return adj, attr, labels


def to_binary_bag_of_words(features):
    """Binarise count features."""
    features = features.copy()
    if sp.issparse(features):
        features.data = np.ones_like(features.data)
        return features
    return (features > 0).astype(features.dtype)


def is_binary_bag_of_words(features):
    if sp.issparse(features):
        return bool(((features.data == 0) | (features.data == 1)).all())
    return bool(((features == 0) | (features == 1)).all())
