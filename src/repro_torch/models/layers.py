"""Shared neural layers (port of `repro.models.layers`): norms, RoPE,
SwiGLU, softcap.  Dense weights keep JAX's ``(d_in, d_out)`` layout."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, device, lead: tuple = ()) -> torch.Tensor:
    """N(0, 1)/√d_in, JAX's ``dense_init``, with ``lead`` stacked axes in
    front (the periods of a layer stack).  On the ``meta`` device ``gen``
    is None and nothing is drawn."""
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(d_in ** -0.5).to(dtype)


def normal_init(gen: Optional[torch.Generator], shape: tuple, std: float,
                dtype: torch.dtype, device,
                slice_elems: int = 1 << 28) -> torch.Tensor:
    """N(0, std²) of ``shape`` in ``dtype``, drawn in f32 a slice of the
    leading axes at a time (at most ``slice_elems`` elements each, but at
    least one row of the trailing two axes), so that a leaf of billions of
    elements never holds an f32 copy of itself: Kimi K2's ``w_gate`` alone
    is 5.6 B elements, 22.5 GB in f32.  On the ``meta`` device nothing is
    drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if gen is None:
        return out
    rows = out.view(-1, *shape[-2:])
    step = max(1, slice_elems // max(1, shape[-2] * shape[-1]))
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        rows[i:i + n] = torch.randn(n, *shape[-2:], generator=gen,
                                    device=device).mul_(std)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def norm(x: torch.Tensor, scale: torch.Tensor, kind: str):
    return rmsnorm(x, scale) if kind == "rmsnorm" else layernorm(x, scale)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap · tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, half-split (not interleaved).
    x: (..., S, H, D), positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freq
    cos = torch.cos(angles)[..., :, None, :]                 # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device,
                lead: tuple = ()) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
