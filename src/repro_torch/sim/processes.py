"""Time-varying channel processes layered on `repro_torch.core.topology`.

Port of `repro.sim.processes`.  Every ingredient of the paper's stationary
topology becomes a process indexed by the round t, re-derived each round:

* **Block Rayleigh fading, Gauss-Markov correlated**:
  h̃_{t+1} = ρ h̃_t + sqrt(1 − ρ²) w_t, w_t ~ CN(0, 1) symmetric; ρ = 1 is
  the static channel.
* **Log-normal shadowing**, AR(1) in dB:
  s_{t+1} = ρ_sh s_t + sqrt(1 − ρ_sh²) n_t, n_t ~ N(0, σ_sh²), entering the
  amplitude as 10^{s/20} (symmetric across each link).
* **Random-waypoint mobility**: each client moves toward its waypoint at
  ``speed`` m/round and draws a fresh one in the area on arrival; positions
  re-derive pathloss, SNRs and the outage graph by `make_topology`'s rules.
* **Imperfect CSI**: a mean-one log-normal factor on the water-filling
  gains (:func:`csi_perturbation`).

The random draws come in from the `repro_torch.sim.draws` seam: unit
normals and uniforms (:class:`ChannelDraws`), made into the processes'
innovations here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.topology import (Topology, TopologyConfig, link_stats,
                                       pathloss_amplitude, pow_f32)


@dataclasses.dataclass(frozen=True)
class ChannelProcessConfig:
    """Knobs of the round-indexed channel process (all off ⇒ paper-static)."""

    fading_rho: float = 1.0        # Gauss-Markov round-to-round correlation ρ
    shadowing_std_db: float = 0.0  # log-normal shadowing σ_sh (dB)
    shadowing_rho: float = 0.9     # AR(1) correlation of the shadowing (dB)
    speed: float = 0.0             # random-waypoint speed (m / round)
    csi_error_std: float = 0.0     # log-std of the water-filling gain error

    @property
    def evolves_geometry(self) -> bool:
        """True when the channel itself changes across rounds (fading,
        shadowing, mobility): the engine carries the process state and
        re-derives the channel view each round (it needs a TopologyConfig).
        CSI error alone does not: it only perturbs the allocator's gains."""
        return (self.fading_rho < 1.0 or self.shadowing_std_db > 0.0
                or self.speed > 0.0)

    @property
    def is_dynamic(self) -> bool:
        """True when anything is re-derived per round (geometry or CSI)."""
        return self.evolves_geometry or self.csi_error_std > 0.0


class ChannelState(NamedTuple):
    """The channel process's state between rounds."""

    positions: torch.Tensor    # (K, 2) client positions
    waypoints: torch.Tensor    # (K, 2) random-waypoint targets
    h_tilde: torch.Tensor      # (K, K) complex64 small-scale fading, E|h|² = 1
    shadow_db: torch.Tensor    # (K, K) symmetric shadowing (dB)


class ChannelView(NamedTuple):
    """One round's realized channel — the Topology fields that vary."""

    link_gain: torch.Tensor    # (K, K) complex64 gains (diag = 0)
    link_snr: torch.Tensor     # (K, K) |h|² P_ref / σ² (diag = 0)
    adjacency: torch.Tensor    # (K, K) bool outage-pruned graph


class ChannelDraws(NamedTuple):
    """One round's draws for :func:`step_channel`, in JAX's split order."""

    fade_re: torch.Tensor      # (K, K) unit normals: innovation, real part
    fade_im: torch.Tensor      # (K, K) unit normals: innovation, imag part
    shadow: torch.Tensor       # (K, K) unit normals: shadowing innovation
    waypoints: torch.Tensor    # (K, 2) uniforms in [0, 1): fresh waypoints


def _symmetrize(m: torch.Tensor, conj: bool) -> torch.Tensor:
    """Mirror the strict upper triangle (channel reciprocity)."""
    K = m.shape[0]
    iu = torch.triu(torch.ones(K, K, dtype=torch.bool, device=m.device),
                    diagonal=1)
    return torch.where(iu, m, m.T.conj() if conj else m.T)


def init_channel(topology: Topology, tcfg: TopologyConfig,
                 waypoints: torch.Tensor) -> ChannelState:
    """Start the process at the given stationary topology: the recovered
    fading reproduces ``topology.link_gain`` at round 0.  ``waypoints``:
    (K, 2) uniforms in [0, 1) for the first waypoints."""
    K = topology.num_clients
    eye = torch.eye(K, dtype=torch.bool, device=topology.link_gain.device)
    pathloss = pathloss_amplitude(topology.positions, tcfg)
    h_tilde = torch.where(eye, 0.0, topology.link_gain / pathloss)
    return ChannelState(positions=topology.positions,
                        waypoints=waypoints * tcfg.area_size,
                        h_tilde=h_tilde.to(torch.complex64),
                        shadow_db=torch.zeros(K, K, dtype=torch.float32,
                                              device=eye.device))


def _ar1(rho: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, sqrt(max(1 − ρ², 0))) in f32."""
    r = torch.full((), rho, dtype=torch.float32, device=device)
    return r, torch.sqrt(torch.clamp(1.0 - r ** 2, min=0.0))


def step_channel(state: ChannelState, cfg: ChannelProcessConfig,
                 tcfg: TopologyConfig, u: ChannelDraws) -> ChannelState:
    """Advance the process one round."""
    dev = state.positions.device

    # Random-waypoint mobility.
    to_target = state.waypoints - state.positions
    dist = torch.sqrt(torch.sum(to_target ** 2, dim=-1, keepdim=True)
                      + 1e-12)
    arrived = dist[:, 0] <= cfg.speed
    positions = state.positions + torch.clamp(cfg.speed / dist,
                                              max=1.0) * to_target
    waypoints = torch.where(arrived[:, None], u.waypoints * tcfg.area_size,
                            state.waypoints)

    # Gauss-Markov Rayleigh fading (ρ = 1 ⇒ exactly static), with a
    # symmetric CN(0, 1) innovation as `make_topology` draws the channel.
    rho, innov_std = _ar1(cfg.fading_rho, dev)
    innov = _symmetrize(torch.complex(u.fade_re / math.sqrt(2.0),
                                      u.fade_im / math.sqrt(2.0)), conj=True)
    h_tilde = rho * state.h_tilde + innov_std * innov

    # AR(1) log-normal shadowing in dB (stationary variance σ_sh²).
    rho_s, shadow_std = _ar1(cfg.shadowing_rho, dev)
    n = _symmetrize(cfg.shadowing_std_db * u.shadow, conj=False)
    shadow_db = rho_s * state.shadow_db + shadow_std * n
    return ChannelState(positions=positions, waypoints=waypoints,
                        h_tilde=h_tilde, shadow_db=shadow_db)


def channel_view(state: ChannelState, tcfg: TopologyConfig) -> ChannelView:
    """One round's gains, SNRs and graph from the process state, by
    `make_topology`'s own rules (`pathloss_amplitude`, `link_stats`)."""
    K = state.positions.shape[0]
    off = 1.0 - torch.eye(K, device=state.positions.device)
    amp = pathloss_amplitude(state.positions, tcfg) * pow_f32(
        torch.full((), 10.0, device=off.device), state.shadow_db / 20.0)
    link_gain = amp * state.h_tilde * off
    # The outage threshold in torch's own log10: XLA's (`xla_math.db10`)
    # costs about 1 ms a round of the cluster-churn scan at K = 50 on an
    # NVIDIA H100 80GB HBM3 (700 W), and buys no bits while this view's
    # link SNRs are a few ulp from JAX's (its pathloss `pow`, `sqrt` and
    # |h|² are not XLA's).
    link_snr, adjacency = link_stats(link_gain, tcfg, db_mode=None)
    return ChannelView(link_gain=link_gain, link_snr=link_snr,
                       adjacency=adjacency)


def csi_perturbation(z: torch.Tensor, log_std: float) -> torch.Tensor:
    """(K,) mean-one log-normal factor exp(σ z − σ²/2) on the water-filling
    gains, from (K,) unit normals ``z``: imperfect CSI at the allocator."""
    return torch.exp(log_std * z - 0.5 * log_std ** 2)
