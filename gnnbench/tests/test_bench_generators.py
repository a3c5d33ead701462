"""The inputs made from the seed: repeatable, at the published sizes,
and the same work for every seed."""

import numpy as np
import pytest
import torch

from gnnbench import data
from gnnbench.harness import load_json
from gnnbench.reference import graph as rgraph
from gnnbench.tests.tiny import ROOT

PRODUCTS = load_json(ROOT / "gnnbench/configs/glnn-products.json")["dataset"]
ARXIV = load_json(ROOT / "gnnbench/configs/gat-arxiv.json")["dataset"]
BIG = 2 ** 31 + 977


def test_published_sizes():
    assert data.n_edges(ARXIV) == 2_501_829
    assert sum(PRODUCTS["split"]) == PRODUCTS["n_nodes"] == 2_449_029
    assert sum(ARXIV["split"]) == ARXIV["n_nodes"] == 169_343


def test_power_law_degrees_at_arxiv_size():
    law = ARXIV["degree_law"]
    deg = data.power_law_degrees(ARXIV["n_nodes"], law["directed_edges"],
                                 law["exponent"])
    assert deg.sum() == 1_166_243 and deg.min() == 3
    assert np.all(np.diff(deg) <= 0)
    # Redner's Zipf law: rank r holds (r - 1/2)^(-1/2) in proportion (the
    # quantiles' midpoints), the top rank what the law gives it
    assert deg[0] == 2005
    for r in (10, 100, 1000):
        assert deg[r - 1] / deg[0] == pytest.approx((0.5 / (r - 0.5)) ** 0.5,
                                                     rel=0.01)
    # rows past both splits: the GAT plan's T = 128 and the SpMM's 512
    assert (deg > 512).sum() == 8 and ((deg > 128) & (deg <= 512)).sum() == 114


@pytest.mark.parametrize("seed", [0, BIG])
def test_nodes_repeat_per_seed_and_split_is_a_partition(seed):
    ds = dict(PRODUCTS, n_nodes=5000, split=[500, 300, 4200])
    a = data.make_nodes(ds, seed, "cpu")
    b = data.make_nodes(ds, seed, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    idx = torch.cat(a[2])
    assert [len(i) for i in a[2]] == ds["split"]
    assert torch.equal(idx.sort().values, torch.arange(5000))
    c = data.make_nodes(ds, seed + 1, "cpu")
    assert not torch.equal(a[0], c[0])


def test_power_law_graph_same_rows_for_every_seed():
    ds = dict(ARXIV, n_nodes=3000, split=[300, 300, 2400],
              degree_law=dict(ARXIV["degree_law"], directed_edges=20000))
    hists = []
    for seed in (1, BIG):
        src, dst = data.make_graph(ds, seed, "cpu")
        again = data.make_graph(ds, seed, "cpu")
        assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
        assert src.dtype == torch.int32
        assert src.shape == (2 * 20000 + 3000,)
        g = rgraph.build(src, dst, 3000)
        in_dir = torch.bincount(dst[:20000].long(), minlength=3000)
        hists.append(np.sort(in_dir.numpy()))
        assert int((g.indptr[1:] - g.indptr[:-1]).min()) >= 1   # self-loops
    assert np.array_equal(hists[0], hists[1])
    assert np.array_equal(hists[0],
                          np.sort(data.power_law_degrees(3000, 20000, 3.0)))


def test_request_sizes_and_sampling():
    sizes = data.request_sizes(10, 4096, 256)
    assert sizes[0] == 10 and sizes[-1] == 4096 and len(sizes) == 256
    r1 = data.Requests(1000, 10, 4096, 256, 64, BIG)
    r2 = data.Requests(1000, 10, 4096, 256, 64, BIG)
    seen = [r1.next() for _ in range(512)]
    again = [r2.next() for _ in range(512)]
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(seen, again))
    lens = sorted(len(ids) for ids, _ in seen)
    assert lens == sorted(list(sizes) * 2)
    assert all(keep for ids, keep in seen if len(ids) == 4096)
    assert 0 < sum(keep for _, keep in seen) < 100


def test_weights_repeat_and_follow_their_laws():
    recipe = load_json(ROOT / "gnnbench/configs/glnn-products.json")["student"]
    spec = data.weight_spec(recipe, 100, 47)
    a = data.make_weights(spec, BIG, "cpu")
    b = data.make_weights(spec, BIG, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["module.layers.0.weight"]
    assert w.shape == (256, 100) and float(w.abs().max()) <= 0.1
    rv = a["module.norms.0.running_var"]
    assert float(rv.min()) >= 0.5 and float(rv.max()) <= 2.0
    gat = load_json(ROOT / "gnnbench/configs/gat-arxiv.json")["teacher"]
    names = [n for n, _, _ in data.weight_spec(gat, 128, 40)]
    assert names == [f"module.convs.{l}.{k}" for l in (0, 1)
                     for k in ("fc.weight", "attn_l", "attn_r")]
    with pytest.raises(ValueError, match="no model file for 'GCN'"):
        data.weight_spec(dict(recipe, model_name="GCN"), 100, 47)
