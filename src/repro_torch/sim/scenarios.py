"""Named scenario registry — the workloads the engine knows how to run.

Port of `repro.sim.scenarios`: the same names and values.  A `Scenario`
bundles a channel process, a participation schedule, a fault process, a
re-clustering cadence and (optionally) an SNR grid for Monte-Carlo sweeps.

* ``paper-static``    — the paper's §V protocol: stationary channel, full
  participation.
* ``mobile-fading``   — random-waypoint mobility, Gauss-Markov fading,
  log-normal shadowing and imperfect CSI.
* ``straggler-heavy`` — 25% i.i.d. dropout plus three deterministic
  stragglers missing every third round, on the static channel.
* ``straggler-prox``  — the same schedule, pinning the ``cwfl_prox``
  strategy (a run under it uses ``cfg.strategy``, with a warning if that
  is another).
* ``snr-sweep``       — static channel and an SNR grid for Monte-Carlo
  sweeps; `run_rounds` runs it as the static scenario at ``cfg.snr_db``.
* ``cluster-churn``   — fading and mobility strong enough that the SNR
  landscape drifts, re-clustering every 5 rounds.
* ``head-failure``    — Markov crash/recovery chains on every node; dead
  cluster-heads are re-elected.
* ``flaky-clients``   — crashes, correlated dropout bursts, deep-fade
  blackouts and i.i.d. dropout, with the divergence guard on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.sim.faults import FaultConfig
from repro_torch.sim.processes import ChannelProcessConfig
from repro_torch.sim.scheduling import ScheduleConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str = "paper-static"
    channel: ChannelProcessConfig = ChannelProcessConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    faults: FaultConfig = FaultConfig()   # node crash/burst/blackout process
    recluster_every: int = 0              # re-run clustering every n rounds (0=never)
    snr_grid: Tuple[float, ...] = ()      # Monte-Carlo SNR axis (dB); () = cfg.snr_db
    #: The scenario's preferred strategy (``None`` = the caller's choice);
    #: ``FLConfig.strategy`` always wins inside the engine.
    strategy: Optional[str] = None

    @property
    def is_static(self) -> bool:
        """True ⇒ the engine takes the paper-static path."""
        return (not self.channel.is_dynamic and self.schedule.is_trivial
                and self.faults.is_trivial and self.recluster_every <= 0)


SCENARIOS = {
    "paper-static": Scenario(),
    "mobile-fading": Scenario(
        name="mobile-fading",
        channel=ChannelProcessConfig(fading_rho=0.9, shadowing_std_db=4.0,
                                     shadowing_rho=0.9, speed=2.0,
                                     csi_error_std=0.1)),
    "straggler-heavy": Scenario(
        name="straggler-heavy",
        schedule=ScheduleConfig(dropout_prob=0.25, num_stragglers=3,
                                straggler_period=3)),
    "straggler-prox": Scenario(
        name="straggler-prox",
        schedule=ScheduleConfig(dropout_prob=0.25, num_stragglers=3,
                                straggler_period=3),
        strategy="cwfl_prox"),
    "snr-sweep": Scenario(
        name="snr-sweep",
        snr_grid=(0.0, 10.0, 20.0, 30.0, 40.0)),
    "cluster-churn": Scenario(
        name="cluster-churn",
        channel=ChannelProcessConfig(fading_rho=0.95, speed=4.0,
                                     shadowing_std_db=2.0),
        recluster_every=5),
    "head-failure": Scenario(
        name="head-failure",
        faults=FaultConfig(crash_prob=0.15, recover_prob=0.3)),
    "flaky-clients": Scenario(
        name="flaky-clients",
        schedule=ScheduleConfig(dropout_prob=0.1),
        faults=FaultConfig(crash_prob=0.05, recover_prob=0.5,
                           burst_prob=0.2, burst_recover_prob=0.5,
                           burst_frac=0.5, deep_fade_prob=0.05,
                           deep_fade_rounds=2, divergence_guard=True,
                           quarantine_norm=100.0)),
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"choose from {sorted(SCENARIOS)}")
    return SCENARIOS[name]
