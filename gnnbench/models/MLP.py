"""MLP (the GLNN student): its weights, drawn as a trained student holds
them: dense layers uniform within 1 / sqrt(fan in) (the port's `Linear`
initial law), and batch norms' affine terms and running statistics spread
as training leaves them (it is served in eval mode)."""

import math


def weight_spec(recipe, feat_dim, label_dim) -> list:
    L, hid = recipe["num_layers"], recipe["hidden_dim"]
    dims = [feat_dim] + [hid] * (L - 1) + [label_dim]
    spec = []
    for l, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        b = 1.0 / math.sqrt(i)
        spec += [(f"module.layers.{l}.weight", (o, i), ("uniform", -b, b)),
                 (f"module.layers.{l}.bias", (o,), ("uniform", -b, b))]
    norm = recipe.get("norm_type", "none")
    if norm == "batch":
        for l in range(L - 1):
            p = f"module.norms.{l}."
            spec += [(p + "weight", (hid,), ("uniform", 0.5, 1.5)),
                     (p + "bias", (hid,), ("normal", 0.0, 0.1)),
                     (p + "running_mean", (hid,), ("normal", 0.0, 0.5)),
                     (p + "running_var", (hid,), ("uniform", 0.5, 2.0))]
    elif norm != "none":
        raise ValueError(f"no weight spec for norm {norm!r}")
    return spec
