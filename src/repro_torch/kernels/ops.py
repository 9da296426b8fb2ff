"""Model-layout wrappers of the port's kernels (port of `repro.kernels.ops`).

``ota_aggregate_op`` runs CWFL's phase-1 MAC over a K-stacked parameter
tree; ``flash_attention_op`` takes the model's (B, S, heads, D) layout,
the kernel (B, heads, S, D).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.kernels.ota_aggregate import ota_aggregate
from repro_torch.utils.pytree import (tree_leaves, tree_map,
                                      tree_unflatten_vector)


def ota_aggregate_op(stacked_params, weights: torch.Tensor,
                     noise: torch.Tensor, noise_std: float):
    """CWFL phase 1 over a K-stacked parameter tree.

    stacked_params: tree with (K, ...) leaves; weights: (C, K); noise:
    (C, d) unit normals, columns in the flat leaf order (JAX draws
    ``normal(key, (C, d))`` in the flat dtype), scaled by ``noise_std``.
    Returns a tree with (C, ...) leaves: the per-cluster aggregates.
    """
    leaves = tree_leaves(stacked_params)
    K = leaves[0].shape[0]
    flat = torch.cat([x.reshape(K, -1) for x in leaves], dim=1)    # (K, d)
    agg = ota_aggregate(flat, weights.to(flat.dtype),
                        noise_std * noise.to(flat.dtype))         # (C, d)
    return tree_unflatten_vector(agg, tree_map(lambda x: x[0],
                                               stacked_params))


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """x (..., D), contiguous, zero-padded on its last axis to the head dim
    the kernels run a head of D at: the least of `HEAD_DIMS` that is ≥ D
    (Kimi K2's 112 runs at 128), D itself where there is none (the kernel's
    wrapper then refuses it).  The choice depends on D alone, on every
    device."""
    D = x.shape[-1]
    pad = next((d for d in HEAD_DIMS if d >= D), D) - D
    return (F.pad(x, (0, pad)) if pad else x).contiguous()


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       cap: float = 0.0) -> torch.Tensor:
    """Model layout: q (B, Sq, H, D); k, v (B, Skv, KV, D) -> (B, Sq, H, D).

    q is scaled by D^-0.5 in its own dtype, as the JAX model's attention
    does (`repro.models.attention.flash_attention`: the scale rounded to
    q's dtype, the product rounded once), and the kernel runs with
    ``scale=1.0``; in bf16 at D = 128 that rounding moves the scores.

    A head dim the kernels are not built for runs at the next one that is
    (`pad_head_dim`), and the output is sliced back: the zero columns add
    nothing to a score, and the padded output columns are zero.
    Differentiable: the gradient runs through the kernel's backward
    (`repro_torch.kernels.flash_attention.FlashAttentionFn`), and through
    the pad and the slice."""
    D = q.shape[3]
    scale = torch.tensor(D ** -0.5, dtype=q.dtype).item()
    o = flash_attention(*(pad_head_dim(x.transpose(1, 2))
                          for x in (q * scale, k, v)),
                        causal=causal, window=window, cap=cap, scale=1.0)
    return o.transpose(1, 2)[..., :D]
