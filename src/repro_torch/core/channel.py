"""Wireless uplink channel model: power control, precoding, OTA MAC
(paper §III).

Port of `repro.core.channel` (water-filling, eq. (5) precoding, the noisy
superposition MAC of eq. (4), the SNR-to-noise budget).
"""
from __future__ import annotations

import torch


def water_filling(channel_gains: torch.Tensor, total_power: float,
                  iters: int = 60) -> torch.Tensor:
    """Water-filling power allocation (paper §III): maximize
    Σ_k log(1 + P_k g_k) s.t. Σ_k P_k = P, by f32 bisection on the water
    level µ with P_k = max(µ − 1/g_k, 0), then an exact renormalization
    onto Σ P_k = P.  Returns (K,) powers."""
    g = torch.clamp(channel_gains.to(torch.float32), min=1e-12)
    inv_g = 1.0 / g
    lo = torch.zeros((), dtype=torch.float32, device=g.device)
    hi = total_power + torch.max(inv_g)
    for _ in range(iters):
        mu = 0.5 * (lo + hi)
        p = torch.clamp(mu - inv_g, min=0.0)
        too_much = torch.sum(p) > total_power
        lo, hi = torch.where(too_much, lo, mu), torch.where(too_much, mu, hi)
    mu = 0.5 * (lo + hi)
    p = torch.clamp(mu - inv_g, min=0.0)
    s = torch.sum(p)
    return torch.where(s > 0, p * (total_power / torch.clamp(s, min=1e-12)),
                       torch.full_like(p, total_power / p.shape[0]))


def precoding_factor(p_k: torch.Tensor,
                     theta_sq_norm: torch.Tensor) -> torch.Tensor:
    """Eq. (5): P_k^t = min(P_k, P_k / E‖θ_k^t‖²)."""
    return torch.minimum(p_k, p_k / torch.clamp(theta_sq_norm, min=1.0))


def precode_amplitude(p_k: torch.Tensor,
                      mean_sq_norm: torch.Tensor) -> torch.Tensor:
    """Eq. (5) amplitude scale sqrt(P_k^t / P_k) ≤ 1, with ``mean_sq_norm``
    the per-channel-use signal power E‖θ_k‖²/d."""
    return torch.sqrt(precoding_factor(p_k, mean_sq_norm)
                      / torch.clamp(p_k, min=1e-12))


def snr_db_to_noise_var(total_power: float, snr_db: float) -> float:
    """σ² such that overall SNR ξ = P/σ² equals ``snr_db`` (paper: 40 dB)."""
    return total_power / (10.0 ** (snr_db / 10.0))


def ota_mac(signals: torch.Tensor, amplitudes: torch.Tensor,
            mask: torch.Tensor, noise: torch.Tensor,
            noise_std) -> torch.Tensor:
    """Noisy superposition MAC (eq. 4 after channel inversion):
    y = Σ_k mask_k · a_k · s_k + σ·w.

    signals: (K, d) channel-inverted transmit signals; amplitudes: (K,)
    per-client sqrt(P_k^t); mask: (K,) {0,1} membership of this receiver's
    MAC; noise: (d,) unit normals w (JAX draws ``normal(key, (d,))``);
    noise_std: the receiver's σ.  Returns (d,)."""
    y = torch.einsum("k,kd->d", amplitudes * mask, signals)
    return y + noise_std * noise.to(y.dtype)
