"""Message-passing op surface with tier dispatch (`glnn_tpu/ops/__init__.py`).

Tiers, by the names `set_backend` keeps for flag parity with the JAX CLI:
  "xla"         the plain f32 tier (ops/refops.py);
  "pallas"      the exact CUDA kernel tier: bf16 messages, f32 sums, for
                the unweighted and the weighted sums (ops/spmm_cuda.py),
                and the GAT attention and segment softmax kernels
                (ops/gat_cuda.py);
  "pallas_int8" the int8 CUDA kernel tier for the unweighted sum:
                per-column int8 messages, exact int32 sums, dequantised;
                the weighted sum and attention stay on the bf16 kernels;
  "auto"        (default) a CPU tensor takes the plain f32 tier; a CUDA
                tensor takes the int8 kernel inside `inference_mode()` with
                eval-quant on, and the exact kernel otherwise. This is the
                JAX rule with "on TPU" read as "the tensor is on CUDA".
On a CPU tensor the kernel tiers run their plain versions; on a CUDA
tensor they launch the kernel or raise, also for shapes outside a
kernel's contract.

A graph other than a `Graph` is one shard of a halo-sharded graph
(`HaloGraph`, distributed/halo.py), and it brings its own op forms: each
op here picks the tier and hands the shard its method of the same name
(`copy_u_sum`, `u_add_v`, `edge_softmax`, `u_mul_e_sum`, so also
`gcn_norm_both` and `appnp_hop`, and `gat_attention`), with `kernel` true
wherever the kernel tier applies, the exact kernels also inside
`inference_mode()` (JAX's halo path never takes int8), else the f32
plain ops. Per-edge tensors on a shard are in its combined CSR's order
(the global dst-sorted order, sliced). This package imports nothing of
the sharded one.
"""

from __future__ import annotations

import torch

from glnn_tpu_torch.graph.container import Graph
from glnn_tpu_torch.ops import cuda_build, gat_cuda, spmm_cuda
from glnn_tpu_torch.ops import refops as _ref

_BACKENDS = ("auto", "xla", "pallas", "pallas_int8")
_BACKEND = "auto"
_EVAL_QUANT = True
_IN_EVAL = False


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown ops backend {name!r}")
    _BACKEND = name


def set_eval_quant(enable: bool) -> None:
    """False (CLI --exact_eval) keeps evals on the exact tier."""
    global _EVAL_QUANT
    _EVAL_QUANT = bool(enable)


class inference_mode:
    """Marks no-grad eval forwards, so that the auto backend may take the
    int8 tier inside them (re-entrant)."""

    def __enter__(self):
        global _IN_EVAL
        self._old = _IN_EVAL
        _IN_EVAL = True

    def __exit__(self, *exc):
        global _IN_EVAL
        _IN_EVAL = self._old


def _tier_selected(device: torch.device) -> bool:
    """Does the kernel tier apply: forced by set_backend, or auto on CUDA."""
    if _BACKEND == "xla":
        return False
    if _BACKEND in ("pallas", "pallas_int8"):
        return True
    return device.type == "cuda"


def _kernel_only(x: torch.Tensor) -> bool:
    """A CUDA tensor under a kernel tier, where only a kernel may run."""
    return x.is_cuda and _tier_selected(x.device)


def eval_quant_active(device: torch.device) -> bool:
    """Does `inference_mode` change the tier for tensors on `device`? Only
    under the auto backend, with eval-quant on, where the kernel tier
    applies."""
    return _tier_selected(device) and _BACKEND == "auto" and _EVAL_QUANT


def _unweighted_tier() -> str:
    if _BACKEND == "pallas_int8":
        return "int8"
    if _BACKEND == "auto" and _IN_EVAL and _EVAL_QUANT:
        return "int8"
    return "bf16"


def copy_u_sum(g, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(g, Graph):
        return g.copy_u_sum(x, kernel=_tier_selected(x.device))
    if x.dim() == 2 and _tier_selected(x.device):
        if _unweighted_tier() == "int8":
            return spmm_cuda.copy_u_sum_int8(g, x)
        return spmm_cuda.copy_u_sum(g, x)
    cuda_build.note_plain(x)
    return _ref.copy_u_sum(g, x)


def copy_u_mean(g, x: torch.Tensor) -> torch.Tensor:
    return copy_u_sum(g, x) / g.in_degrees.clamp(min=1.0)[:, None]


def u_add_v(g, a_u: torch.Tensor, a_v: torch.Tensor) -> torch.Tensor:
    """Per-edge a_u[src] + a_v[dst]; plain torch on every tier, as in JAX."""
    if not isinstance(g, Graph):
        return g.u_add_v(a_u, a_v)
    return _ref.u_add_v(g, a_u, a_v)


def edge_softmax(g, scores: torch.Tensor) -> torch.Tensor:
    """Softmax over each dst's in-edges of scores [E] or [E, H]."""
    kernel = scores.dim() in (1, 2) and _tier_selected(scores.device)
    if not kernel and _kernel_only(scores):
        raise ValueError(f"the edge_softmax kernel takes scores [E] or "
                         f"[E, H], got {tuple(scores.shape)}")
    if not isinstance(g, Graph):
        return g.edge_softmax(scores, kernel=kernel)
    if kernel:
        return gat_cuda.edge_softmax(g, scores)
    cuda_build.note_plain(scores)
    return _ref.edge_softmax(g, scores)


def u_mul_e_sum(g, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """h_v = sum_u e_uv x_u: x [N, F] with e [E], or x [N, H, D] with
    per-head e [E, H]. The kernel tier rounds each message to bf16 under
    both kernel backends, as JAX keeps the weighted sum on its bf16 tier."""
    kernel = (((x.dim() == 2 and e.dim() == 1)
               or (x.dim() == 3 and e.dim() == 2))
              and _tier_selected(x.device))
    if not kernel and _kernel_only(x):
        raise ValueError(f"the weighted SpMM kernel takes x [N, F] with e "
                         f"[E], or x [N, H, D] with e [E, H]; got "
                         f"{tuple(x.shape)} and {tuple(e.shape)}")
    if not isinstance(g, Graph):
        return g.u_mul_e_sum(x, e, kernel=kernel)
    if kernel:
        return spmm_cuda.u_mul_e_sum(g, x, e)
    cuda_build.note_plain(x)
    return _ref.u_mul_e_sum(g, x, e)


def gcn_norm_both(g, x: torch.Tensor, edge_weight=None) -> torch.Tensor:
    """D^-1/2 A D^-1/2 x (degrees clamped >= 1) through the dispatched
    copy_u_sum, or u_mul_e_sum with per-edge weights (APPNP's edge drop)."""
    return _ref.gcn_norm_both(g, x, edge_weight, copy_u_sum, u_mul_e_sum)


# APPNP's hops by path (`appnp_hop`), apart from the kernels' launch counts
hop_counts = {"fused_weighted": 0, "fused_int8": 0, "composed": 0}


def reset_counts() -> None:
    """Zero `hop_counts` and the SpMM wrappers' counts
    (`spmm_cuda.reset_counts`)."""
    for k in hop_counts:
        hop_counts[k] = 0
    spmm_cuda.reset_counts()


def _appnp_path(g, h: torch.Tensor, h0: torch.Tensor, weighted: bool) -> str:
    """The path of one hop: "fused_weighted" with edge-drop weights,
    "fused_int8" on the int8 tier with no gradient, each on a Graph with h
    and h0 f32 [N, F] under a kernel tier; "composed" for every other: a
    halo shard, the exact tier, bf16 rows and the plain f32 tier (auto on
    the CPU)."""
    if (not isinstance(g, Graph) or h.dtype != torch.float32
            or h0.dtype != torch.float32 or h.dim() != 2
            or not _tier_selected(h.device)):
        return "composed"
    if weighted:
        return "fused_weighted"
    if (_unweighted_tier() == "int8"
            and not (torch.is_grad_enabled() and h.requires_grad)):
        return "fused_int8"
    return "composed"


def appnp_hop(g, h: torch.Tensor, h0: torch.Tensor, edge_weight,
              alpha: float) -> torch.Tensor:
    """One APPNP hop, (1 - alpha) D^-1/2 A_w D^-1/2 h + alpha h0, with
    `edge_weight` [E] (edge drop) or None; counted in `hop_counts` by
    path. Where `_appnp_path` allows it runs inside the SpMM walk
    (`spmm_cuda.appnp_hop`, `spmm_cuda.appnp_hop_int8`), else as
    `gcn_norm_both` and the teleport; both give the same numbers."""
    path = _appnp_path(g, h, h0, edge_weight is not None)
    hop_counts[path] += 1
    if path == "fused_weighted":
        return spmm_cuda.appnp_hop(g, h, h0, edge_weight, alpha)
    if path == "fused_int8":
        return spmm_cuda.appnp_hop_int8(g, h, h0, alpha)
    prop = gcn_norm_both(g, h, edge_weight=edge_weight)
    return (1.0 - alpha) * prop + alpha * h0


def gat_attention(g, feat: torch.Tensor, attn_l: torch.Tensor,
                  attn_r: torch.Tensor, *, slope: float = 0.2,
                  drop_rate: float = 0.0,
                  gen: torch.Generator | None = None) -> torch.Tensor:
    """The whole GAT attention layer (scores -> leaky_relu -> edge_softmax
    -> attention dropout -> weighted aggregate) as one op. feat [N, H, D]
    (= Wh), attn_l / attn_r [H, D]; returns [N, H, D]. Dropout draws one
    Philox seed from `gen` (an int64 tensor on feat's device, so no host
    sync); the keep bits of (dst-sorted edge, head) follow from it
    (`gat_cuda.philox_keep`), the same on every tier and device, and on a
    halo shard the single-device bits of its global edges (every rank
    draws the same seed from its generator, seeded alike). Under a kernel
    tier this is the fused attention (bf16 features, f32 softmax and sums),
    whose kernels generate the bits themselves; otherwise the f32
    composition of the dispatched plain ops."""
    seed = None
    inv_keep = 1.0 / (1.0 - drop_rate)
    if drop_rate > 0.0:
        seed = torch.randint(2 ** 63 - 1, (1,), dtype=torch.int64,
                             generator=gen, device=feat.device)
    if feat.dim() == 3 and _tier_selected(feat.device):
        if not isinstance(g, Graph):
            return g.gat_attention(feat, attn_l, attn_r, slope, seed,
                                   inv_keep)
        return gat_cuda.gat_attention(g, feat, attn_l, attn_r, slope, seed,
                                      inv_keep)
    el = (feat * attn_l[None]).sum(-1)                 # [N, H]
    er = (feat * attn_r[None]).sum(-1)
    e = u_add_v(g, el, er)                             # [E, H]
    e = torch.where(e >= 0, e, slope * e)
    alpha = edge_softmax(g, e)
    if seed is not None:
        keep = gat_cuda.philox_keep(seed, g.n_edges, feat.shape[1],
                                    1.0 / inv_keep, g.edge_base)
        alpha = alpha * keep.to(alpha.dtype) / (1.0 - drop_rate)
    return u_mul_e_sum(g, feat, alpha)


__all__ = [
    "copy_u_sum", "copy_u_mean", "u_add_v", "edge_softmax", "u_mul_e_sum",
    "gat_attention", "gcn_norm_both", "appnp_hop", "hop_counts",
    "reset_counts", "set_backend", "set_eval_quant", "inference_mode",
    "eval_quant_active",
]
