"""Client geometry, pathloss and outage-derived graph topology (paper §III, §V).

Port of `repro.core.topology`.  Each link (k, j) is a Rayleigh-faded
channel with distance-dependent amplitude pathloss (d_0^{-1} d_{k,j})^{-ς/2};
pilot signals determine which links are in outage, and the surviving links
define the undirected graph G(V, L).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.xla_math import db10, xla_link_snr, xla_pathloss
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    num_clients: int = 50
    area_size: float = 100.0          # clients placed uniformly in [0, area]^2
    d0: float = 1.0                   # reference distance (m)
    pathloss_exp: float = 2.2         # ς
    noise_var: float = 1.0            # receiver AWGN variance sigma^2 (pre power-scale)
    total_power: float = 1e4          # P = sum_k P_k (40 dB overall SNR for sigma^2=1)
    outage_snr_db: float = -5.0       # links below this SNR are in outage
    num_hotspots: int = 3             # geometric hotspots -> natural SNR clusters
    hotspot_std: float = 6.0


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static wireless topology: positions, complex link gains, SNRs, graph."""

    positions: torch.Tensor           # (K, 2) f32
    link_gain: torch.Tensor           # (K, K) complex64 h̃ * pathloss (diag=0)
    link_snr: torch.Tensor            # (K, K) |h|^2 * Pref / sigma^2 (diag=0)
    adjacency: torch.Tensor           # (K, K) bool, outage-pruned graph L
    noise_var: float
    total_power: float

    @property
    def num_clients(self) -> int:
        return int(self.positions.shape[0])

    def to(self, device) -> "Topology":
        return dataclasses.replace(
            self, positions=self.positions.to(device),
            link_gain=self.link_gain.to(device),
            link_snr=self.link_snr.to(device),
            adjacency=self.adjacency.to(device))


def pathloss_amplitude(positions: torch.Tensor, cfg: TopologyConfig,
                       mode: str = "eager") -> torch.Tensor:
    """(K, K) amplitude pathloss (d/d0)^{-ς/2} from positions
    (ε-regularized distance, clamped at d0), as XLA computes it in JAX's
    context ``mode`` (`xla_math.xla_pathloss`: ``"eager"`` for a drawn
    topology and a run's first channel state, ``"jit"`` in a round and in
    a sweep's setup).  Leading axes batch."""
    return xla_pathloss(positions, cfg.d0, -cfg.pathloss_exp / 2.0, mode)


def link_stats(link_gain: torch.Tensor, cfg: TopologyConfig):
    """(link_snr, adjacency) from a (K, K) complex gain matrix: SNR at the
    equal-split reference power P/K and the dB-threshold outage pruning,
    as XLA computes them eagerly, for a drawn topology (a round's view is
    `repro_torch.sim.processes`')."""
    K = link_gain.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=link_gain.device)
    link_snr = xla_link_snr(link_gain.real, link_gain.imag,
                            cfg.total_power / K, cfg.noise_var)
    adjacency = (db10(link_snr, "eager") >= cfg.outage_snr_db) & ~eye
    return link_snr, adjacency


def make_topology(seed: int = 0, cfg: Optional[TopologyConfig] = None,
                  device=None) -> Topology:
    """Draw a stationary topology (paper: channel constant across rounds)
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None`` = the GPU)."""
    cfg = cfg or TopologyConfig()
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    K = cfg.num_clients

    # Clients cluster geometrically around hotspots (D2D neighbourhoods),
    # which is what gives SNR-based K-means meaningful clusters.
    hot = torch.rand(cfg.num_hotspots, 2, generator=gen,
                     device=device) * cfg.area_size
    assign = torch.randint(0, cfg.num_hotspots, (K,), generator=gen,
                           device=device)
    jitter = torch.randn(K, 2, generator=gen, device=device) * cfg.hotspot_std
    positions = hot[assign] + jitter

    # Pairwise distances and Rayleigh small-scale fading, CN(0, 1).
    pathloss_amp = pathloss_amplitude(positions, cfg)
    re = torch.randn(K, K, generator=gen, device=device) / math.sqrt(2.0)
    im = torch.randn(K, K, generator=gen, device=device) / math.sqrt(2.0)
    h_tilde = torch.complex(re, im)
    # Reciprocity: keep the upper triangle, mirror its conjugate below.
    iu = torch.triu(torch.ones(K, K, dtype=torch.bool, device=device),
                    diagonal=1)
    h_tilde = torch.where(iu, h_tilde, h_tilde.T.conj())
    # Eager complex products, by the amplitude and then by the mask, their
    # zero terms kept as XLA's (they sign the zeros of the diagonal).
    off = 1.0 - torch.eye(K, device=device)
    g_re = pathloss_amp * h_tilde.real - 0.0 * h_tilde.imag
    g_im = pathloss_amp * h_tilde.imag + 0.0 * h_tilde.real
    link_gain = torch.complex(off * g_re - g_im * 0.0,
                              off * g_im + g_re * 0.0)

    link_snr, adjacency = link_stats(link_gain, cfg)
    return Topology(positions=positions, link_gain=link_gain,
                    link_snr=link_snr, adjacency=adjacency,
                    noise_var=cfg.noise_var, total_power=cfg.total_power)
