"""Plain PyTorch versions of the port's kernels (port of `repro.kernels.ref`).

The CPU route of every kernel wrapper runs these, the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import torch


def cwfl_round_ref(signals: torch.Tensor, phase1: torch.Tensor,
                   noise1: torch.Tensor, phase2: torch.Tensor,
                   noise2: torch.Tensor, broadcast: torch.Tensor,
                   guard: bool = False):
    """Three-pass CWFL sync round, f32 throughout.

    signals: (K, d); phase1: (C, K) Ã; noise1: (C, d); phase2: (C, C) B̃;
    noise2: (C, d); broadcast: (K, C) downlink matrix (membership.T).
    Returns ``(new (K, d) in signals.dtype, consensus (d,) f32)``.

    ``guard`` (fault scenarios): non-finite signals become 0 before phase
    1 (0 × NaN = NaN, so a zero amplitude cannot contain them), and an Ã
    row with Σ|Ã| = 0 (an all-failed cluster) forces its θ̃ row, noise
    included, to 0.
    """
    s = signals.to(torch.float32)
    a = phase1.to(torch.float32)
    if guard:
        s = torch.where(torch.isfinite(s), s, 0.0)
    theta_tilde = a @ s + noise1.to(torch.float32)
    if guard:
        dead = torch.sum(torch.abs(a), dim=1, keepdim=True) <= 0.0
        theta_tilde = torch.where(dead, 0.0, theta_tilde)
    theta_bar = (phase2.to(torch.float32) @ theta_tilde
                 + noise2.to(torch.float32))
    new = (broadcast.to(torch.float32) @ theta_bar).to(signals.dtype)
    return new, torch.mean(theta_bar, dim=0)
