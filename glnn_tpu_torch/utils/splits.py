"""Train/val/test splits (`glnn_tpu/utils/splits.py`).

Given the same `np.random.RandomState(seed)`, these issue the same sequence
of `choice` and `permutation` calls as the JAX package, so splits are
identical:
* `get_train_val_test_split`: per-class stratified (or size-based) splits;
* `graph_split`: the inductive split. `rate` of the test set is hidden as
  the inductive test set; train, val and the rest of the test set form the
  observed graph, `idx_obs = concat(train, val, test_tran)` (not sorted:
  obs node i is global node idx_obs[i]). It returns the obs-local index
  system (`obs_idx_*`, positions within idx_obs) and the global indices
  (`idx_obs`, `idx_test_ind`).
"""

from __future__ import annotations

import numpy as np


def idx_split(idx: np.ndarray, ratio: float, seed: int = 0):
    """Randomly split idx into (ratio, 1 - ratio) portions."""
    idx = np.asarray(idx)
    perm = np.random.RandomState(seed).permutation(len(idx))
    cut = int(len(idx) * ratio)
    return idx[perm[:cut]], idx[perm[cut:]]


def graph_split(idx_train, idx_val, idx_test, rate: float, seed: int):
    """(obs_idx_train, obs_idx_val, obs_idx_test, idx_obs, idx_test_ind)."""
    idx_train, idx_val = np.asarray(idx_train), np.asarray(idx_val)
    idx_test_ind, idx_test_tran = idx_split(idx_test, rate, seed)
    idx_obs = np.concatenate([idx_train, idx_val, idx_test_tran])
    n1, n2 = idx_train.shape[0], idx_val.shape[0]
    obs_idx_all = np.arange(idx_obs.shape[0])
    return (obs_idx_all[:n1], obs_idx_all[n1:n1 + n2], obs_idx_all[n1 + n2:],
            idx_obs, idx_test_ind)


def sample_per_class(random_state, labels_onehot, num_examples_per_class,
                     forbidden_indices=None):
    """Sample a fixed number of node indices per class, skipping any in
    `forbidden_indices`."""
    num_samples, num_classes = labels_onehot.shape
    forbidden = (
        np.zeros(num_samples, bool)
        if forbidden_indices is None
        else np.isin(np.arange(num_samples), forbidden_indices)
    )
    picks = []
    for c in range(num_classes):
        members = np.where((labels_onehot[:, c] > 0.0) & ~forbidden)[0]
        picks.append(
            random_state.choice(members, num_examples_per_class, replace=False)
        )
    return np.concatenate(picks)


def get_train_val_test_split(random_state, labels_onehot,
                             train_examples_per_class=None,
                             val_examples_per_class=None,
                             test_examples_per_class=None,
                             train_size=None, val_size=None, test_size=None):
    """Stratified (or size-based) disjoint train/val/test node splits."""
    num_samples, _ = labels_onehot.shape
    remaining = np.arange(num_samples)

    if train_examples_per_class is not None:
        train_idx = sample_per_class(random_state, labels_onehot,
                                     train_examples_per_class)
    else:
        train_idx = random_state.choice(remaining, train_size, replace=False)

    if val_examples_per_class is not None:
        val_idx = sample_per_class(random_state, labels_onehot,
                                   val_examples_per_class,
                                   forbidden_indices=train_idx)
    else:
        remaining = np.setdiff1d(remaining, train_idx)
        val_idx = random_state.choice(remaining, val_size, replace=False)

    forbidden = np.concatenate([train_idx, val_idx])
    if test_examples_per_class is not None:
        test_idx = sample_per_class(random_state, labels_onehot,
                                    test_examples_per_class,
                                    forbidden_indices=forbidden)
    elif test_size is not None:
        remaining = np.setdiff1d(remaining, forbidden)
        test_idx = random_state.choice(remaining, test_size, replace=False)
    else:
        test_idx = np.setdiff1d(np.arange(num_samples), forbidden)

    for idx in (train_idx, val_idx, test_idx):
        if len(np.unique(idx)) != len(idx):
            raise ValueError("split holds a node twice")
    if (np.intersect1d(train_idx, val_idx).size
            or np.intersect1d(train_idx, test_idx).size
            or np.intersect1d(val_idx, test_idx).size):
        raise ValueError("splits overlap")
    return train_idx, val_idx, test_idx
