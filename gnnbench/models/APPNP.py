"""APPNP: its weights' initial laws (the MLP head's, as the port's `Linear`
draws them) and the work of a full-batch runner epoch, from shapes alone,
by the rules of `work.py`: one train step (the MLP's forward and backward,
K weighted hops forward and K transposed weighted hops backward, each at
the logits' width), then the all-node eval's forward (the MLP and K int8
hops). The hops' elementwise ops (norms, teleport, edge-drop weights,
quantisation) are not counted."""

from gnnbench import find

weight_spec = find.module("models", "MLP").weight_spec


def dims(recipe, feat_dim, label_dim) -> list:
    """[(in, out)] of each dense layer of the MLP head."""
    L, hid = recipe["num_layers"], recipe["hidden_dim"]
    d = [feat_dim] + [hid] * (L - 1) + [label_dim]
    return list(zip(d[:-1], d[1:]))


def mlp_flops(recipe, feat_dim, label_dim, n, train=True) -> float:
    """The head's dense products over n rows: 2 n i o each forward; with
    `train` the weight gradient (2 n i o) and, past the first layer, the
    input gradient (2 n i o)."""
    total = 0.0
    for l, (i, o) in enumerate(dims(recipe, feat_dim, label_dim)):
        gemm = 2.0 * n * i * o
        total += gemm
        if train:
            total += gemm + (gemm if l > 0 else 0.0)
    return total


def weighted_op(n, e, f) -> tuple[float, float]:
    """(bytes, flops) of one forward weighted hop: the row pointer, the
    sources, x f32 and the weights f32 in; out f32; a multiply and an add
    per edge and column."""
    nbytes = (n + 1) * 4 + e * 4 + n * f * 4 + e * 4 + n * f * 4
    return float(nbytes), float(2 * e * f)


def weighted_t_op(n, e, f) -> tuple[float, float]:
    """(bytes, flops) of one transposed weighted hop (dX): the transposed
    row pointer, each slot's dst and edge, dh f32 and the weights f32 in;
    out f32."""
    nbytes = (n + 1) * 4 + 3 * e * 4 + n * f * 4 + n * f * 4
    return float(nbytes), float(2 * e * f)


def int8_op(n, e, f) -> tuple[float, float]:
    """(bytes, flops) of one int8 hop: the row pointer, the sources, the
    int8 rows and the f32 scales in; out f32; an add per edge and
    column."""
    nbytes = (n + 1) * 4 + e * 4 + n * f + f * 4 + n * f * 4
    return float(nbytes), float(e * f)


def epoch_flops(recipe, ds, n_edges) -> float:
    n, f, c = ds["n_nodes"], ds["n_feats"], ds["n_classes"]
    k = recipe["k"]
    return (mlp_flops(recipe, f, c, n, train=True)
            + mlp_flops(recipe, f, c, n, train=False)
            + 2 * k * weighted_op(n, n_edges, c)[1]
            + k * int8_op(n, n_edges, c)[1])


def epoch_ops(recipe, ds, n_edges) -> dict:
    """{kernel op: [(bytes, flops) of each call in one epoch]}: K forward
    and K transposed weighted hops in the train step, K int8 hops in the
    eval."""
    n, c, k = ds["n_nodes"], ds["n_classes"], recipe["k"]
    return {"spmm_csr_weighted": ([weighted_op(n, n_edges, c)] * k
                                  + [weighted_t_op(n, n_edges, c)] * k),
            "spmm_csr_int8": [int8_op(n, n_edges, c)] * k}
