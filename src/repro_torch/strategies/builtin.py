"""The paper's strategies on the Strategy protocol (port of
`repro.strategies.builtin`).  This slice registers ``cwfl``: Algorithm 1's
clustered two-phase OTA aggregation (`repro_torch.core.cwfl`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import cwfl
from repro_torch.strategies.base import Strategy, register_strategy


@dataclasses.dataclass(frozen=True)
class CWFLStrategy(Strategy):
    """Algorithm 1: cluster on SNR, water-fill, two-phase OTA aggregation."""

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        return cwfl.setup(
            topology,
            cwfl.CWFLConfig(num_clusters=cfg.num_clusters, snr_db=snr_db),
            draws.kmeans_first(topology.num_clients))

    def aggregate(self, stacked_params, state, noise):
        return cwfl.aggregate(stacked_params, state, noise)


register_strategy("cwfl", CWFLStrategy(name="cwfl"))
