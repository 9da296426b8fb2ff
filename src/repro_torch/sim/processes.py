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

The random draws come in from the `repro_torch.sim.draws` seam: normals
of variance ½ and uniforms (:class:`ChannelDraws`), made into the
processes' innovations here.

A round's step and view are XLA's arithmetic, bit for bit, as JAX's
jitted round computes them (`repro_torch.core.xla_math`): one launch of
the `repro_torch.kernels.channel_view` kernel on the card, its plain
version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.topology import (Topology, TopologyConfig,
                                       pathloss_amplitude)
from repro_torch.core.xla_math import channel_constants
from repro_torch.kernels.channel_view import channel_round


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
    """One round's draws for :func:`step_and_view`, in JAX's split order.
    The normals have variance ½: they are JAX's ``erf_inv(u)``, its unit
    normal before the √2, which XLA folds into the constants that scale
    it (`xla_math.channel_constants`)."""

    fade_re: torch.Tensor      # (K, K) N(0, ½): innovation, real part
    fade_im: torch.Tensor      # (K, K) N(0, ½): innovation, imag part
    shadow: torch.Tensor       # (K, K) N(0, ½): shadowing innovation
    waypoints: torch.Tensor    # (K, 2) uniforms in [0, 1): fresh waypoints


def init_channel(topology: Topology, tcfg: TopologyConfig,
                 waypoints: torch.Tensor, mode: str = "eager"
                 ) -> ChannelState:
    """Start the process at the given stationary topology: the recovered
    fading reproduces ``topology.link_gain`` at round 0.  ``waypoints``:
    (..., K, 2) uniforms in [0, 1) for the first waypoints, the leading
    axes those of a sweep's trajectories.  ``mode``: the context JAX
    computes the pathloss in (`pathloss_amplitude`): eagerly for a run,
    ``"jit"`` in a sweep's setup."""
    K = topology.num_clients
    lead = tuple(waypoints.shape[:-2])
    eye = torch.eye(K, dtype=torch.bool, device=topology.link_gain.device)
    pathloss = pathloss_amplitude(topology.positions, tcfg, mode)
    # XLA's complex division by a real divisor divides each part.
    g = topology.link_gain
    h_tilde = torch.complex(torch.where(eye, 0.0, g.real / pathloss),
                            torch.where(eye, 0.0, g.imag / pathloss))
    return ChannelState(
        positions=topology.positions.expand(lead + (K, 2)).clone(),
        waypoints=waypoints * tcfg.area_size,
        h_tilde=h_tilde.expand(lead + (K, K)).clone(),
        shadow_db=torch.zeros(lead + (K, K), dtype=torch.float32,
                              device=eye.device))


def _constants(cfg: ChannelProcessConfig, tcfg: TopologyConfig,
               K: int) -> dict:
    return channel_constants(
        speed=cfg.speed, fading_rho=cfg.fading_rho,
        shadowing_rho=cfg.shadowing_rho,
        shadowing_std_db=cfg.shadowing_std_db, area_size=tcfg.area_size,
        d0=tcfg.d0, pathloss_exp=tcfg.pathloss_exp,
        p_ref=tcfg.total_power / K, noise_var=tcfg.noise_var,
        outage_snr_db=tcfg.outage_snr_db)


def step_and_view(state: ChannelState, cfg: ChannelProcessConfig,
                  tcfg: TopologyConfig, u: ChannelDraws
                  ) -> tuple[ChannelState, ChannelView]:
    """Advance the process one round and realize the round's gains, SNRs
    and graph by `make_topology`'s rules, as JAX's jitted round does
    (one kernel launch on the card).  Leading axes batch trajectories."""
    out = channel_round(*state, u, _constants(cfg, tcfg,
                                              state.positions.shape[-2]))
    return ChannelState(*out[:4]), ChannelView(*out[4:])


def csi_perturbation(z: torch.Tensor, log_std: float) -> torch.Tensor:
    """(K,) mean-one log-normal factor exp(σ z − σ²/2) on the water-filling
    gains, from (K,) unit normals ``z``: imperfect CSI at the allocator."""
    return torch.exp(log_std * z - 0.5 * log_std ** 2)
