"""Plain PyTorch versions of the port's kernels (port of `repro.kernels.ref`).

The CPU route of every kernel wrapper runs these, the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import torch


def ota_aggregate_ref(signals: torch.Tensor, weights: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """Phase-1 OTA MAC for all clusters at once: y = W @ S + N in f32.

    signals: (K, d) channel-inverted client parameter vectors; weights:
    (C, K) per-(cluster, client) amplitudes (0 for non-members); noise:
    (C, d) receiver noise.  Returns (C, d) in the signals' dtype.  With a
    leading trajectory axis — (B, K, d), (B, C, K), (B, C, d) — each of
    the B products is its own (the batched kernel's plain version)."""
    return (weights.to(torch.float32) @ signals.to(torch.float32)
            + noise.to(torch.float32)).to(signals.dtype)


def cwfl_round_ref(signals: torch.Tensor, phase1: torch.Tensor,
                   noise1: torch.Tensor, phase2: torch.Tensor,
                   noise2: torch.Tensor, broadcast: torch.Tensor,
                   guard: bool = False):
    """Three-pass CWFL sync round, f32 throughout.

    signals: (K, d); phase1: (C, K) Ã; noise1: (C, d); phase2: (C, C) B̃;
    noise2: (C, d); broadcast: (K, C) downlink matrix (membership.T).
    Returns ``(new (K, d) in signals.dtype, consensus (d,) f32)``.  With a
    leading trajectory axis on every argument — signals (B, K, d) and so
    on — each of the B rounds is its own, and the outputs are (B, K, d)
    and (B, d) (the batched kernel's plain version).

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
        dead = torch.sum(torch.abs(a), dim=-1, keepdim=True) <= 0.0
        theta_tilde = torch.where(dead, 0.0, theta_tilde)
    theta_bar = (phase2.to(torch.float32) @ theta_tilde
                 + noise2.to(torch.float32))
    new = (broadcast.to(torch.float32) @ theta_bar).to(signals.dtype)
    return new, torch.mean(theta_bar, dim=-2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        cap: float = 0.0,
                        scale: float | None = None) -> torch.Tensor:
    """Exact softmax attention, f32 throughout.  q: (B, H, Sq, D); k, v:
    (B, KV, Skv, D); query head h reads KV head h // (H / KV); q is
    multiplied by ``scale`` in f32 (default D^-0.5).  A row with no valid
    key gives 0.  Returns (B, H, Sq, D) in q's dtype."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, KV, H // KV, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s.masked_fill_(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p.masked_fill_(torch.isnan(p), 0.0)     # fully-masked rows -> 0
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, D).to(q.dtype)
