"""Per-round telemetry (port of `repro.obs.telemetry`).

:class:`RoundTelemetry` is the per-round observation nest the engine's
round (`repro_torch.sim.engine`, `repro_torch.sim.sharded`) emits when
``telemetry=True``, a flag fixed for the run: with it off the carry, the
launches and every bit of the history are those of a run without it.

* ``cluster_loss``      — per-aggregation-site mean client loss, from a
  fresh full-shard forward on the locally trained params (never a second
  reduction over the round's minibatch losses): (C,) for CWFL's clusters,
  (1,) for a server or decentralized strategy;
* ``participants``      — effective transmit-side participation after
  masking and the forced-present rules (heads, the COTAF server);
* ``consensus_drift``   — ‖θ_site − θ̄‖ per site;
* ``channel_uses`` / ``cum_channel_uses`` / ``cum_symbols`` — the OTA
  channel-use ledger (`repro_torch.obs.ledger`): MAC slots this round, the
  running slot total and the running scalar-symbol total (slots × d),
  both kept in f32 as JAX keeps them, so they round where JAX's round;
* ``reclustered``       — 1.0 on a round that re-clustered;
* ``extras``            — strategy internals from the ``Strategy.
  telemetry`` hook (CWFL: eq. (5) precode scales, water-filled P_k,
  per-channel-use transmit power against the budget, the phase-1/2
  receiver-noise stds and the expected injected-noise energy; COTAF: the
  server and its MAC noise; decentralized: graph occupancy), and a fault
  scenario's events under ``fault_*`` keys.

Everything is plain torch on tensors the round already holds (plus the
one fresh forward): no draws, no host syncs, so a captured round records
it on every replay.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.nest import nest_tensors


class RoundTelemetry(NamedTuple):
    """One round's observations; a nest (`repro_torch.utils.nest`), so it
    rides the round's outputs and stacks over rounds and trajectories."""

    cluster_loss: Any       # (C,) or (1,) mean client loss per site
    participants: Any       # () effective transmit-side count
    consensus_drift: Any    # (C,) or (1,) ‖θ_site − θ̄‖
    channel_uses: Any       # () MAC slots consumed this round
    cum_channel_uses: Any   # () running slot ledger
    cum_symbols: Any        # () running scalar-symbol ledger (slots × d)
    reclustered: Any        # () {0,1} re-cluster event fired
    extras: dict            # strategy-specific internals


def init_ledger(device) -> dict:
    """The zeroed cumulative channel-use ledger of the round's carry."""
    return {"uses": torch.zeros((), dtype=torch.float32, device=device),
            "symbols": torch.zeros((), dtype=torch.float32, device=device)}


def per_client_dim(stacked) -> int:
    """d = dim(θ_k): scalars a client of a K-stacked tree."""
    return sum(x[0].numel() for x in nest_tensors(stacked))


def stacked_consensus_drift(stacked, consensus) -> torch.Tensor:
    """(R,) ℓ₂ distance of each leading-axis row of ``stacked`` from the
    ``consensus`` tree (one client, head or site a row)."""
    rows_of = nest_tensors(stacked)
    rows = rows_of[0].shape[0]
    sq = sum(
        torch.sum(torch.square(
            x.to(torch.float32).reshape(rows, -1)
            - c.to(torch.float32).reshape(-1)[None, :]), dim=1)
        for x, c in zip(rows_of, nest_tensors(consensus)))
    return torch.sqrt(sq)


def _f32(x, device) -> torch.Tensor:
    """``x`` (a number or a tensor) as an f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def build_round_telemetry(strategy, state, *, losses, stacked, new_stacked,
                          consensus, mask, num_clients: int,
                          num_clusters: int, ledger: dict,
                          reclustered=None, fault_extras=None):
    """One :class:`RoundTelemetry` from the round's intermediates and the
    `Strategy.telemetry` hook, and the cumulative channel-use ledger
    advanced.  Returns ``(telemetry, new_ledger)``.

    ``state`` is the round's aggregation state (the rebuilt one in a
    dynamic scenario); ``losses`` the (K,) full-shard losses; ``stacked``
    the locally trained, pre-sync stack; ``new_stacked`` and ``consensus``
    the sync's outputs; ``reclustered`` a 0-d f32 tensor (``None``: the
    scenario never re-clusters); ``fault_extras`` the fault plane's
    events (alive, tx_ok, burst, deep_fade, quarantined), merged into
    ``extras`` as ``fault_*`` (``None`` without a fault plane)."""
    dev = losses.device
    t = strategy.telemetry(state, losses=losses, stacked=stacked,
                           new_stacked=new_stacked, consensus=consensus,
                           mask=mask)
    extras = t.get("extras", {})
    if fault_extras is not None:
        extras = dict(extras)
        extras.update({f"fault_{k}": _f32(v, dev)
                       for k, v in fault_extras.items()})
    uses = _f32(strategy.channel_uses(num_clients, num_clusters=num_clusters,
                                      participants=t["participants"]), dev)
    d = per_client_dim(stacked)
    new_ledger = {"uses": ledger["uses"] + uses,
                  "symbols": ledger["symbols"] + uses * d}
    tele = RoundTelemetry(
        cluster_loss=t["cluster_loss"],
        participants=t["participants"],
        consensus_drift=t["consensus_drift"],
        channel_uses=uses,
        cum_channel_uses=new_ledger["uses"],
        cum_symbols=new_ledger["symbols"],
        reclustered=(torch.zeros((), dtype=torch.float32, device=dev)
                     if reclustered is None else _f32(reclustered, dev)),
        extras=extras)
    return tele, new_ledger
