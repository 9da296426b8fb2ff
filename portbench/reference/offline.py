"""The reference's offline phase and round coefficients (paper §IV).

Clustering: each client's feature is its link-SNR profile in dB (outage
links floored at −30 dB); K-means with farthest-point initialization
from a drawn first centre groups the clients, and the member nearest
each centroid becomes its head.  ``argmin``/``argmax`` take the first
occurrence.  A two-member cluster puts both members at the same distance
from its centroid in exact arithmetic, so the f32 rounding of the sum of
squares picks its head; that sum is taken in the order XLA's CPU
reduction takes it (copied, with the dB, from the simulator's plain
arithmetic, see `portbench.reference.xla`).

Then water-filling power (f32 bisection on the water level, renormalized
onto Σ P_k = P), the consensus weights W of eq. (9), and each round's
weight set: the phase-1 amplitudes with eq. (5)'s precoding, both
phases renormalized into convex combinations with their noise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.xla import _fma_f32, db10


def _kmeans(features, C: int, first, iters: int = 50):
    centers = torch.as_tensor(first, dtype=torch.int64,
                              device=features.device).reshape(1)
    for _ in range(1, C):
        d2 = torch.sum((features[:, None, :] - features[centers][None]) ** 2,
                       dim=-1)
        pick = torch.argmax(torch.min(d2, dim=1).values)
        centers = torch.cat([centers, pick.reshape(1)])
    centroids = features[centers]
    for _ in range(iters):
        d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
        onehot = F.one_hot(torch.argmin(d2, dim=1), C).to(features.dtype)
        counts = torch.clamp(onehot.sum(0), min=1.0)
        new = (onehot.T @ features) / counts[:, None]
        empty = (onehot.sum(0) == 0)[:, None]
        centroids = torch.where(empty, centroids, new)
    d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1), centroids


def _sum_in_xla_order(x):
    n = x.shape[-1]
    if n <= 32:
        total = x[..., 0]
        for i in range(1, n):
            total = total + x[..., i]
        return total
    blocks = -(-n // 32)
    front = (32 * blocks - n) // 2
    sums = []
    for b in range(blocks):
        start, stop = max(32 * b - front, 0), min(32 * (b + 1) - front, n)
        sums.append(_sum_in_xla_order(x[..., start:stop]))
    return _sum_in_xla_order(torch.stack(sums, dim=-1))


def _sum_sq(diff, jitted: bool):
    if not jitted or diff.shape[-1] > 32:
        return _sum_in_xla_order(diff * diff)
    acc = torch.zeros(diff.shape[:-1], dtype=torch.float32,
                      device=diff.device)
    for i in range(diff.shape[-1]):
        acc = _fma_f32(diff[..., i], diff[..., i], acc)
    return acc


def cluster_plan(link_snr, adjacency, C: int, first, *, jitted: bool,
                 db_mode: str) -> dict:
    """K-means on the SNR features, the heads, and ξ_c (the mean
    member→head link SNR, the head's self-link left out; a singleton's is
    the largest link SNR)."""
    feats = torch.clamp(torch.where(adjacency, db10(link_snr, db_mode),
                                    -30.0), min=-30.0)
    assign, centroids = _kmeans(feats, C, first)
    clusters = torch.arange(C, device=feats.device)
    d2 = _sum_sq(feats[:, None, :] - centroids[None], jitted)
    d2 = torch.where(assign[:, None] == clusters[None], d2, torch.inf)
    heads = torch.argmin(d2, dim=0)
    membership = (assign[None, :] == clusters[:, None]).to(torch.float32)
    K = link_snr.shape[0]
    head_onehot = F.one_hot(heads, K).to(torch.float32)
    member_not_head = membership * (1.0 - head_onehot)
    denom = torch.clamp(member_not_head.sum(1), min=1.0)
    xi = (link_snr[heads] * member_not_head).sum(1) / denom
    xi = torch.where(member_not_head.sum(1) > 0, xi, torch.max(link_snr))
    return {"assign": assign, "heads": heads, "membership": membership,
            "xi": xi, "head_mask": head_onehot.sum(0)}


def water_filling(gains, total_power: float, iters: int = 60):
    """max Σ log(1 + P_k g_k) s.t. Σ P_k = P: f32 bisection on the water
    level, then an exact renormalization."""
    g = torch.clamp(gains.to(torch.float32), min=1e-12)
    inv_g = 1.0 / g
    lo = torch.zeros((), dtype=torch.float32, device=g.device)
    hi = total_power + torch.max(inv_g)
    for _ in range(iters):
        mu = 0.5 * (lo + hi)
        too_much = torch.sum(torch.clamp(mu - inv_g, min=0.0)) > total_power
        lo, hi = torch.where(too_much, lo, mu), torch.where(too_much, mu, hi)
    p = torch.clamp(0.5 * (lo + hi) - inv_g, min=0.0)
    s = torch.sum(p)
    return torch.where(s > 0, p * (total_power / torch.clamp(s, min=1e-12)),
                       torch.full_like(p, total_power / p.shape[0]))


def sync_state(plan: dict, gain_re, gain_im, total_power: float,
               noise_var) -> dict:
    """Water-filled powers and the consensus weights of a plan under the
    given (K, K) complex gains: a head's gain is the mean head→head |g|²,
    a member's its link to its head; the receivers' noise std is σ."""
    heads, assign = plan["heads"], plan["assign"]
    K, C = assign.shape[0], heads.shape[0]
    dev = assign.device
    g_abs = torch.abs(torch.complex(gain_re, gain_im)) ** 2
    gain_to_head = g_abs[torch.arange(K, device=dev), heads[assign]]
    mean_h2h = g_abs[heads][:, heads].sum() / max(C * (C - 1), 1)
    eff = torch.where(plan["head_mask"] > 0, mean_h2h, gain_to_head)
    power = water_filling(eff / noise_var, total_power)
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=dev)
    xi = plan["xi"]
    off = 1.0 - torch.eye(C, device=dev)
    denom = (off * xi[None, :]).sum(dim=1, keepdim=True)
    return {"power": power, "sigma": torch.sqrt(nv),
            "mix": off * xi[None, :] / torch.clamp(denom, min=1e-12)}


def round_weights(plan: dict, sync: dict, total_power: float, mean_sq):
    """``(A, std1, B, kappa, M)`` of one round: the precoded phase-1
    amplitudes and receiver std, the phase-2 mix and its equivalent std,
    both renormalized by their row sums, and the broadcast (K, C)."""
    C = plan["heads"].shape[0]
    dev = mean_sq.device
    p_k = sync["power"]
    head = plan["head_mask"] > 0
    w_k = torch.where(head, 1.0, torch.sqrt(p_k / total_power))
    A = plan["membership"] * w_k[None, :]
    pre = torch.sqrt(torch.minimum(p_k, p_k / torch.clamp(mean_sq, min=1.0))
                     / torch.clamp(p_k, min=1e-12))
    A = A * torch.where(head, 1.0, pre)[None, :]
    sqrt_p = torch.sqrt(torch.full((), total_power, dtype=torch.float32,
                                   device=dev))
    std = torch.full((C,), 1.0, dtype=torch.float32, device=dev) * sync["sigma"]
    rows = torch.clamp(A.sum(dim=1, keepdim=True), min=1e-12)
    A, std1 = A / rows, (std / sqrt_p) / rows[:, 0]
    mix = sync["mix"]
    B = mix + torch.eye(C, device=dev)
    kappa = torch.sqrt(torch.sum(mix ** 2, dim=1)) * (std / sqrt_p)
    row_sums = B.sum(dim=1, keepdim=True)
    return A, std1, B / row_sums, kappa / row_sums[:, 0], plan["membership"].T
