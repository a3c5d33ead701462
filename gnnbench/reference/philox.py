"""Philox4x32-10 in int64 arithmetic, and the GAT attention's keep mask.

The port's GAT kernels draw their dropout bits from a seed: edge e (its
position in the dst-sorted order) keeps head h iff word h & 3 of
Philox4x32-10 at counter (e, h >> 2, 0, 0) under key (seed lo, seed hi)
lies below min(keep * 2**32, 2**32 - 1). This module computes the same
mask from the same seed.
"""

from __future__ import annotations

import torch

M = (0xD2511F53, 0xCD9E8D57)
W = (0x9E3779B9, 0xBB67AE85)
U32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    lo16 = m * (x & 0xFFFF)
    hi16 = m * (x >> 16)
    mid = ((hi16 & 0xFFFF) << 16) + lo16
    return (hi16 >> 16) + (mid >> 32), mid & U32


def philox(ctr, key):
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W[0]) & U32, (k1 + W[1]) & U32
        hi0, lo0 = _mulhilo(M[0], c0)
        hi1, lo1 = _mulhilo(M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, n_edges: int, heads: int,
              keep: float) -> torch.Tensor:
    """bool [E, H]."""
    s = seed.reshape(-1)[:1].long()
    key = (s & U32, (s >> 32) & U32)
    threshold = min(int(float(keep) * 2.0 ** 32), 2 ** 32 - 1)
    e = torch.arange(n_edges, dtype=torch.int64, device=seed.device) & U32
    zero = torch.zeros_like(e)
    cols = []
    for c in range(-(-heads // 4)):
        words = philox((e, torch.full_like(e, c), zero, zero), key)
        cols.append(torch.stack(words, 1))
    return torch.cat(cols, 1)[:, :heads] < threshold
