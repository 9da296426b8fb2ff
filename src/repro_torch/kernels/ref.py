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


def _attention_mask(Sq: int, Skv: int, causal: bool, window: int, device):
    """(Sq, Skv) keys each query row sees: k ≤ q (causal), k > q − window
    (window > 0)."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, scale: float | None = None,
                        return_lse: bool = False):
    """Exact softmax attention, f32 throughout.  q: (B, H, Sq, D); k, v:
    (B, KV, Skv, D); query head h reads KV head h // (H / KV); q is
    multiplied by ``scale`` in f32 (default D^-0.5).  A row with no valid
    key gives 0.  Returns (B, H, Sq, D) in q's dtype, and with
    ``return_lse`` also the row statistics log Σ exp(s), (B, H, Sq) f32
    (the kernels' second output, which the backward reads)."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, KV, H // KV, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    mask = _attention_mask(Sq, Skv, causal, window, q.device)
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    # Fully-masked rows -> 0; out of place, so autograd runs through it.
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    o = o.reshape(B, H, Sq, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            cap: float = 0.0, scale: float | None = None):
    """The gradient of :func:`flash_attention_ref` from its row statistics,
    f32 throughout (the backward kernel's plain version).

    q, o, do: (B, H, Sq, D); k, v: (B, KV, Skv, D); lse: (B, H, Sq) f32,
    the forward's log Σ exp(s) a row (−inf for a row with no key).  With
    P = exp(s − lse) on the unmasked pairs and 0 elsewhere:

        dV = Σ_g Pᵀ dO               Δ = rowsum(dO ∘ O)
        dP = dO Vᵀ                   dS = P ∘ (dP − Δ) ∘ (1 − tanh²(s/cap))
        dQ = scale · dS K            dK = Σ_g dSᵀ (q · scale)

    the softcap's factor only where cap > 0, the sums over g those over
    the G query heads of a KV head.  Returns ``(dq, dk, dv)`` in the
    dtypes of q, k and v."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qg = (q.to(f32) * scale).reshape(B, KV, G, Sq, D)
    kf, vf = k.to(f32), v.to(f32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
    if cap > 0.0:
        t = torch.tanh(s / cap)
        s = cap * t
    mask = _attention_mask(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(f32).reshape(
        B, KV, G, Sq, 1)), 0.0)
    dog = do.to(f32).reshape(B, KV, G, Sq, D)
    delta = torch.sum(dog * o.to(f32).reshape(B, KV, G, Sq, D), dim=-1,
                      keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    if cap > 0.0:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
