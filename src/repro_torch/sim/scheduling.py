"""Per-round client participation: dropouts, stragglers, energy budgets.

Port of `repro.sim.scheduling`.  A round's participation mask
m_t ∈ {0,1}^K folds into the round coefficients
(`repro_torch.core.cwfl.round_coefficients(mask=)`): an absent client gets
a zero column in Ã before the renormalization.  Cluster-heads are always
present (`cwfl.participation_weights`).  Three mechanisms compose (AND):

* **Bernoulli dropout**: each client absent w.p. ``dropout_prob``;
* **deterministic stragglers**: clients 0..S−1 miss every round with
  t ≡ period−1 (mod period);
* **energy budgets**: each client can afford ``energy_budget``
  transmissions, then goes silent for good.  Participation spends one;
  sitting out spends none.

The dropout draw comes in as (K,) uniforms from the `repro_torch.sim.draws`
seam; ``u < 1 − dropout_prob`` keeps a client, as ``jax.random.bernoulli``
decides.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    dropout_prob: float = 0.0     # per-round i.i.d. absence probability
    num_stragglers: int = 0       # clients 0..S-1 straggle deterministically
    straggler_period: int = 0     # straggle when t % period == period-1 (0=off)
    energy_budget: float = 0.0    # max participations per client (0 = ∞)

    @property
    def is_trivial(self) -> bool:
        """True when every mechanism is off: the engine skips masking."""
        return (self.dropout_prob <= 0.0
                and (self.num_stragglers <= 0 or self.straggler_period <= 0)
                and self.energy_budget <= 0.0)


class ScheduleState(NamedTuple):
    energy_left: torch.Tensor     # (K,) remaining transmissions (∞ = unbounded)


def init_schedule(cfg: ScheduleConfig, num_clients: int,
                  device) -> ScheduleState:
    budget = cfg.energy_budget if cfg.energy_budget > 0 else float("inf")
    return ScheduleState(energy_left=torch.full(
        (num_clients,), budget, dtype=torch.float32, device=device))


def participation_mask(cfg: ScheduleConfig, state: ScheduleState, t: int,
                       u: torch.Tensor) -> tuple[torch.Tensor,
                                                 ScheduleState]:
    """One round's (K,) f32 {0,1} mask from the round's (K,) uniforms,
    and the new state."""
    K = u.shape[0]
    keep = u < 1.0 - cfg.dropout_prob
    if (cfg.num_stragglers > 0 and cfg.straggler_period > 0
            and t % cfg.straggler_period == cfg.straggler_period - 1):
        keep = keep & (torch.arange(K, device=u.device)
                       >= cfg.num_stragglers)
    mask = ((state.energy_left > 0.0) & keep).to(torch.float32)
    return mask, ScheduleState(energy_left=state.energy_left - mask)
