"""Channel-use accounting — the one source of truth for the paper's
communication-cost claim (§IV/§VI); port of `repro.obs.ledger`.

The per-round MAC-slot count of each aggregation strategy lives on the
`repro_torch.strategies.Strategy` object itself (``Strategy.channel_uses``
— plain arithmetic on numbers or tensors, so the in-round telemetry
ledger and the host-side tables can never disagree).  This module is the
host-side front door:

* :func:`uses_per_round` — resolve a strategy by name through the
  registry and evaluate its per-round slot count;
* :func:`per_round_table` — the paper's §IV comparison row (CWFL's
  C(C−1)+C vs decentralized K(K−1) vs a single server MAC);
* :func:`symbols_per_round` — slots × d: the scalar symbols one sync of a
  d-dimensional model costs (each MAC slot carries one d-dimensional OTA
  superposition).

One "channel use" is one scheduled MAC slot (an OTA superposition or one
directed head→head/node→node transmission).  ``fedavg`` counts 0 — the
genie-aided noiseless bound with no wireless channel at all.
"""
from __future__ import annotations

from typing import Optional


def uses_per_round(strategy, num_clients: int,
                   num_clusters: Optional[int] = None,
                   participants=None):
    """Per-round channel uses of ``strategy`` (a registry name or a
    `Strategy`), delegated to ``Strategy.channel_uses``.  ``participants``
    (optional, may be a tensor): the effective participant count after
    masking, read by graph-based strategies (decentralized: P(P−1))."""
    from repro_torch.strategies import get_strategy
    return get_strategy(strategy).channel_uses(
        num_clients, num_clusters=num_clusters, participants=participants)


def symbols_per_round(strategy, dim: int, num_clients: int,
                      num_clusters: Optional[int] = None,
                      participants=None):
    """Scalar symbols per sync round: slots × d (one d-dim vector a slot)."""
    return uses_per_round(strategy, num_clients, num_clusters=num_clusters,
                          participants=participants) * dim


def per_round_table(num_clients: int, num_clusters: int) -> dict:
    """The paper's §IV efficiency comparison for one (K, C) point, each
    entry from the registered strategy's own ``channel_uses``."""
    return {
        "cwfl": uses_per_round("cwfl", num_clients, num_clusters),
        "decentralized": uses_per_round("decentralized", num_clients),
        "server_ota": uses_per_round("cotaf", num_clients),
    }
