"""GAT: its weights' initial laws (as the port's `GATConv` draws them),
and the work of a full-batch runner epoch (one train step, forward and
backward, then the all-node eval's forward), from shapes alone, by the
rules of `work.py`."""

import math


def weight_spec(recipe, feat_dim, label_dim) -> list:
    """Per layer the dense weight (xavier normal, gain sqrt 2) and the two
    attention vectors (normal, gain sqrt 2 over their width)."""
    spec = []
    for l, (i, h, d) in enumerate(layers(recipe, feat_dim, label_dim)):
        spec += [
            (f"module.convs.{l}.fc.weight", (h * d, i),
             ("normal", 0.0, math.sqrt(2.0) * math.sqrt(2.0 / (i + h * d)))),
            (f"module.convs.{l}.attn_l", (h, d),
             ("normal", 0.0, math.sqrt(2.0) * math.sqrt(1.0 / d))),
            (f"module.convs.{l}.attn_r", (h, d),
             ("normal", 0.0, math.sqrt(2.0) * math.sqrt(1.0 / d)))]
    return spec


def layers(recipe, feat_dim, label_dim) -> list:
    """[(in, heads, width)] of each GAT layer."""
    L, heads = recipe["num_layers"], recipe["num_heads"]
    per = recipe["hidden_dim"] // heads
    return [(feat_dim if l == 0 else per * heads,
             heads if l < L - 1 else 1,
             per if l < L - 1 else label_dim) for l in range(L)]


def step_flops(recipe, feat_dim, label_dim, n, e, train=True) -> float:
    """Full-graph GAT forward (and with `train` its backward): the dense
    product, the two score vectors, per edge and head the score (4), the
    softmax (4) and the weighted sum (2 D); the backward per edge and head
    the recomputed weight (6), the weight's gradient (2 D + 6), the
    message (4 D) and a_l's gradient (2 D), the source sum of the
    messages, and the dense product's gradients."""
    total = 0.0
    for l, (i, h, d) in enumerate(layers(recipe, feat_dim, label_dim)):
        gemm = 2.0 * n * i * h * d
        fwd = gemm + 4.0 * n * h * d + e * h * (8 + 2 * d)
        total += fwd
        if train:
            total += (gemm + e * h * (12 + 8 * d) + e * h * d
                      + 4.0 * n * h * d)
            if l > 0:
                total += gemm
    return total


def fwd_op(n, e, h, d) -> tuple[float, float]:
    """(bytes, flops) of one gat_fwd: the row pointer, the sources, the
    bf16 features, el f32 and er bf16 in; out f32 and the max and
    denominator f32 out."""
    nbytes = ((n + 1) * 4 + e * 4 + n * h * d * 2 + n * h * 4 + n * h * 2
              + n * h * d * 4 + 2 * n * h * 4)
    return float(nbytes), float(e * h * (8 + 2 * d))


def bwd_op(n, e, h, d) -> tuple[float, float]:
    """(bytes, flops) of one gat_bwd: the forward's inputs, its max and
    denominator, dout f32 and bf16 a_l in; der f32, the bf16 message per
    edge and a_l's gradient out."""
    nbytes = ((n + 1) * 4 + e * 4 + n * h * d * 2 + n * h * 4 + n * h * 2
              + 2 * n * h * 4 + n * h * d * 4 + h * d * 2
              + n * h * 4 + e * h * d * 2 + h * d * 4)
    return float(nbytes), float(e * h * (12 + 8 * d))


def epoch_flops(recipe, ds, n_edges) -> float:
    n, f, c = ds["n_nodes"], ds["n_feats"], ds["n_classes"]
    return (step_flops(recipe, f, c, n, n_edges, train=True)
            + step_flops(recipe, f, c, n, n_edges, train=False))


def epoch_ops(recipe, ds, n_edges) -> dict:
    """{kernel op: [(bytes, flops) of each call in one epoch]}: gat_fwd in
    the train step and in the eval, gat_bwd in the train step."""
    n = ds["n_nodes"]
    ls = layers(recipe, ds["n_feats"], ds["n_classes"])
    return {"gat_fwd": [fwd_op(n, n_edges, h, d) for _, h, d in ls] * 2,
            "gat_bwd": [bwd_op(n, n_edges, h, d) for _, h, d in ls]}
