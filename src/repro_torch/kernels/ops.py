"""Model-layout wrappers of the port's kernels (port of `repro.kernels.ops`).

``flash_attention_op`` takes the model's (B, S, heads, D) layout; the
kernel takes (B, heads, S, D).  ``ota_aggregate_op`` waits for the
``dist/`` slice (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       cap: float = 0.0) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k, v (B, S, KV, D) -> (B, S, H, D)."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=causal, window=window, cap=cap)
    return o.transpose(1, 2)
