"""Round-indexed fault processes: crashes, dropout bursts, blackouts.

Port of `repro.sim.faults`.  The paper's premise is that "a powerful
server may not be available … due to … server failures"; this module makes
node failure a process indexed by the round t, realized each round into a
:class:`FaultView` that the engine folds into the participation mask and
the strategy's head-failure handoff.  Three mechanisms compose:

* **Markov crash/recovery chains**: every node is a 2-state chain,
  P(up → down) = ``crash_prob``, P(down → up) = ``recover_prob``.  A down
  node neither transmits nor receives.
* **Correlated dropout bursts**: a global 2-state burst chain; while a
  burst is active each client is silenced w.p. ``burst_frac``.
* **Deep-fade blackouts**: w.p. ``deep_fade_prob`` a round starts a
  blackout of ``deep_fade_rounds`` rounds in which no client transmits.

The **divergence guard** (:func:`quarantine_mask`) flags clients whose
update is non-finite or whose per-channel-use power exceeds
``quarantine_norm``; the engine zeroes their mask entry and reverts their
params to the round's start (0 × NaN = NaN, so masking alone cannot stop a
poisoned transmit).

The random draws come in as uniforms (:class:`FaultDraws`, from the
`repro_torch.sim.draws` seam) and the decisions are taken here:
``u < p`` is how ``jax.random.bernoulli`` decides.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.cwfl import per_client_mean_sq
from repro_torch.utils.pytree import tree_leaves


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of the round-indexed fault process (all off ⇒ no faults)."""

    crash_prob: float = 0.0          # P(up → down) per node per round
    recover_prob: float = 0.0        # P(down → up) per node per round
    burst_prob: float = 0.0          # P(calm → burst) per round
    burst_recover_prob: float = 0.0  # P(burst → calm) per round
    burst_frac: float = 0.0          # P(client silenced | burst active)
    deep_fade_prob: float = 0.0      # P(blackout starts) per round
    deep_fade_rounds: int = 1        # blackout length (rounds)
    divergence_guard: bool = False   # quarantine poisoned client updates
    quarantine_norm: float = 0.0     # ‖θ‖²/d quarantine threshold (0 = only
                                     # non-finite updates are quarantined)

    @property
    def is_trivial(self) -> bool:
        """True when every mechanism is off: the engine skips the fault
        plane entirely."""
        return (self.crash_prob <= 0.0 and self.burst_prob <= 0.0
                and self.deep_fade_prob <= 0.0
                and not self.divergence_guard)


class FaultState(NamedTuple):
    """The fault process's state between rounds."""

    node_up: torch.Tensor    # (K,) f32 {0,1}: Markov up/down per node
    burst: torch.Tensor      # () f32 {0,1}: dropout burst active
    fade_left: torch.Tensor  # () f32: blackout rounds remaining


class FaultView(NamedTuple):
    """One round's realized faults — what the engine folds in."""

    alive: torch.Tensor      # (K,) {0,1} node up (crashed nodes are 0)
    tx_ok: torch.Tensor      # (K,) {0,1} can transmit: alive ∧ ¬burst ∧ ¬fade
    burst: torch.Tensor      # () {0,1} dropout burst active this round
    deep_fade: torch.Tensor  # () {0,1} blackout active this round


class FaultDraws(NamedTuple):
    """One round's uniforms in [0, 1), f32, in JAX's split order."""

    crash: torch.Tensor      # (K,)
    recover: torch.Tensor    # (K,)
    enter: torch.Tensor      # ()
    leave: torch.Tensor      # ()
    hit: torch.Tensor        # (K,)
    fade: torch.Tensor       # ()


def init_faults(cfg: FaultConfig, num_clients: int, device) -> FaultState:
    """Everyone up, no burst, no blackout at round 0."""
    del cfg
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return FaultState(node_up=torch.ones(num_clients, dtype=torch.float32,
                                         device=device),
                      burst=zero, fade_left=zero.clone())


def step_faults(state: FaultState, cfg: FaultConfig, u: FaultDraws
                ) -> tuple[FaultState, FaultView]:
    """Advance every fault chain one round."""
    # Per-node 2-state Markov chain.
    up = torch.where(state.node_up > 0,
                     (u.crash >= cfg.crash_prob).to(torch.float32),
                     (u.recover < cfg.recover_prob).to(torch.float32))

    # Global burst chain + i.i.d. per-client hits while it is active.
    burst = torch.where(state.burst > 0,
                        (u.leave >= cfg.burst_recover_prob).to(torch.float32),
                        (u.enter < cfg.burst_prob).to(torch.float32))
    hit = (u.hit < cfg.burst_frac).to(torch.float32)
    burst_ok = 1.0 - burst * hit

    # Deep-fade blackout: a countdown; a new blackout starts only once the
    # previous one has drained.
    fade_left = torch.clamp(state.fade_left - 1.0, min=0.0)
    start = (u.fade < cfg.deep_fade_prob) & (fade_left <= 0.0)
    fade_left = torch.where(start, float(cfg.deep_fade_rounds), fade_left)
    fading = (fade_left > 0.0).to(torch.float32)

    tx_ok = up * burst_ok * (1.0 - fading)
    return (FaultState(node_up=up, burst=burst, fade_left=fade_left),
            FaultView(alive=up, tx_ok=tx_ok, burst=burst, deep_fade=fading))


def quarantine_mask(stacked, limit: float = 0.0) -> torch.Tensor:
    """(K,) {0,1} health flag per client of a K-stacked tree: 1 iff the
    client's update is finite and (when ``limit > 0``) its per-channel-use
    power ‖θ_k‖²/d — eq. (5)'s estimator, `cwfl.per_client_mean_sq` — is
    at most ``limit``."""
    leaves = tree_leaves(stacked)
    rows = leaves[0].shape[0]
    ok = torch.ones(rows, dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        ok &= torch.all(torch.isfinite(x.reshape(rows, -1)), dim=1)
    if limit > 0.0:
        ok &= per_client_mean_sq(stacked) <= limit
    return ok.to(torch.float32)
