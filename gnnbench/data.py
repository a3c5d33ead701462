"""Inputs made from the seed: graphs, features, labels, splits, weights
and request sizes.

Everything is drawn on the run's device from a `torch.Generator` seeded
from `--seed` and a tag, in a few large calls. Shapes that set the work
(degree sequences, request sizes) are the same multiset for every seed,
and the seed only decides which node or request gets which: so two seeds
ask the same work of the program, in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnnbench import work

# tags that split one run seed into independent streams
TAGS = {"graph": 1, "feats": 2, "split": 3, "weights": 4, "program": 5,
        "requests": 7, "sample": 8}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each input of a run."""
    return (int(seed) * 1_000_003 + TAGS[tag] * 7_919) % (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ---- graphs -----------------------------------------------------------------

def power_law_degrees(n: int, m: int, exponent: float) -> np.ndarray:
    """A fixed in-degree sequence of n nodes summing to m: the quantiles of
    a Pareto law P(x) ~ x^-exponent, so that the node of rank r holds
    about r^(-1 / (exponent - 1)) of the top one's, scaled to sum to m,
    rounded down and the remainder given to the largest fractional parts.
    No cap: the largest is what the law gives the top rank. Sorted
    descending; the same for every seed."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    x = q ** (-1.0 / (exponent - 1.0))           # descending quantiles
    d = x * (m / x.sum())
    base = np.floor(d).astype(np.int64)
    rest = m - int(base.sum())
    assert 0 <= rest <= n, rest
    base[np.argsort(-(d - base), kind="stable")[:rest]] += 1
    return base


def power_law_graph(n: int, m: int, exponent: float, gen: torch.Generator,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """`m` directed edges whose in-degrees follow `power_law_degrees` (the
    seed decides which node gets which degree) with uniform sources (no
    self-edge), then their reverse edges and one self-loop per node, as
    the OGB loader adds them: int32 src, dst of 2 m + n edges."""
    deg = torch.from_numpy(power_law_degrees(n, m, exponent)).to(device)
    owner = torch.randperm(n, generator=gen, device=device)
    dst = torch.repeat_interleave(owner, deg)
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    src = torch.where(src == dst, (src + 1) % n, src)
    loops = torch.arange(n, device=device)
    return (torch.cat([src, dst, loops]).to(torch.int32),
            torch.cat([dst, src, loops]).to(torch.int32))


def make_graph(ds: dict, seed: int, device):
    """(src, dst) int32 device tensors of the configuration's graph."""
    law = ds["degree_law"]
    if law["kind"] != "power_law":
        raise ValueError(f"unknown degree law {law['kind']!r}")
    return power_law_graph(ds["n_nodes"], law["directed_edges"],
                           law["exponent"], generator(seed, "graph", device),
                           device)


def n_edges(ds: dict) -> int:
    """The edge count of the configuration's graph: the directed edges,
    their reverses and a self-loop per node."""
    return 2 * ds["degree_law"]["directed_edges"] + ds["n_nodes"]


# ---- node data --------------------------------------------------------------

def make_nodes(ds: dict, seed: int, device):
    """(feats f32 [N, F], labels int64 [N], (idx_train, idx_val, idx_test)
    int64): labels uniform over the classes, features a class centroid
    plus unit noise, the split sizes of the dataset over a permutation."""
    n, f, c = ds["n_nodes"], ds["n_feats"], ds["n_classes"]
    gen = generator(seed, "feats", device)
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    feats = torch.randn((n, f), generator=gen, device=device)
    feats += ds["features"]["centroid_scale"] * torch.randn(
        (c, f), generator=gen, device=device)[labels]
    perm = torch.randperm(n, generator=generator(seed, "split", device),
                          device=device)
    a, b, t = ds["split"]
    if a + b + t > n:
        raise ValueError(f"split {ds['split']} exceeds {n} nodes")
    return feats, labels, (perm[:a], perm[a:a + b], perm[a + b:a + b + t])


# ---- weights ----------------------------------------------------------------

def weight_spec(recipe: dict, feat_dim: int, label_dim: int) -> list:
    """[(name, shape, (law, a, b))] of a model's state: law "uniform" on
    [a, b] or "normal" with mean a and std b, from
    `models/<model_name>.py`. Names are the state-dict keys of the port's
    `Model`, which the reference reads too."""
    return work.model_work(recipe["model_name"]).weight_spec(
        recipe, feat_dim, label_dim)


def make_weights(spec: list, seed: int, device) -> dict:
    """The state of `spec` from one uniform and one normal draw on
    `device`, f32."""
    gen = generator(seed, "weights", device)
    size = {law: sum(math.prod(s) for _, s, (l, *_) in spec if l == law)
            for law in ("uniform", "normal")}
    pools = {"uniform": torch.rand(size["uniform"], generator=gen,
                                   device=device),
             "normal": torch.randn(size["normal"], generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (law, a, b) in spec:
        k = math.prod(shape)
        v = pools[law][at[law]:at[law] + k].view(shape)
        at[law] += k
        out[name] = a + (b - a) * v if law == "uniform" else a + b * v
    return out


# ---- requests ---------------------------------------------------------------

def request_sizes(lo: int, hi: int, distinct: int) -> np.ndarray:
    """`distinct` sizes log-uniform over [lo, hi], both ends included."""
    t = np.arange(distinct, dtype=np.float64) / max(distinct - 1, 1)
    return np.rint(np.exp(np.log(lo) + t * (np.log(hi) - np.log(lo)))).astype(
        np.int64)


class Requests:
    """The closed loop's requests: sizes cycle through `request_sizes` in a
    new seeded order each cycle, node ids uniform over n, and whether a
    request is kept for the check (every size-`hi` request, and 1 in
    `sample_every` of the others) drawn from a stream of its own."""

    def __init__(self, n: int, lo: int, hi: int, distinct: int,
                 sample_every: int, seed: int):
        self.n, self.hi = n, hi
        self.sizes = request_sizes(lo, hi, distinct)
        self.rng = np.random.default_rng(sub_seed(seed, "requests"))
        self.pick = np.random.default_rng(sub_seed(seed, "sample"))
        self.sample_every = sample_every
        self.cycle: list = []

    def next(self) -> tuple[np.ndarray, bool]:
        if not self.cycle:
            self.cycle = list(self.rng.permutation(self.sizes))
        size = int(self.cycle.pop())
        ids = self.rng.integers(0, self.n, size)
        keep = size == self.hi or self.pick.integers(self.sample_every) == 0
        return ids, bool(keep)
