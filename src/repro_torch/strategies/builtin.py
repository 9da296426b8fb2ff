"""The paper's strategies on the Strategy protocol (port of
`repro.strategies.builtin`).  The port registers ``cwfl``: Algorithm 1's
clustered two-phase OTA aggregation (`repro_torch.core.cwfl`)."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

from repro_torch.core import clustering as cl
from repro_torch.core import cwfl
from repro_torch.strategies.base import Strategy, register_strategy


@dataclasses.dataclass(frozen=True)
class CWFLStrategy(Strategy):
    """Algorithm 1: cluster on SNR, water-fill, two-phase OTA aggregation."""

    supports_client_sharding: ClassVar[bool] = True

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        return cwfl.setup(
            topology,
            cwfl.CWFLConfig(num_clusters=cfg.num_clusters, snr_db=snr_db),
            draws.kmeans_first(topology.num_clients))

    def state_from_view(self, state0, view, noise_var, *, csi=None,
                        mask=None, plan=None, alive=None):
        del mask, alive   # folded into the round coefficients by aggregate()
        return cwfl.state_from_plan(
            state0.plan if plan is None else plan, view.link_gain,
            state0.total_power, noise_var, csi_perturb=csi)

    def aggregate(self, stacked_params, state, noise, mask=None,
                  alive=None):
        # A fault round (``alive`` given) runs the guarded kernel.
        return cwfl.aggregate(stacked_params, state, noise, mask=mask,
                              alive=alive)

    def receive_mask(self, state, mask, alive=None):
        # Heads are the phase-1/2 receivers: they keep the aggregate they
        # computed, unless they crashed.
        return cwfl.participation_weights(state, mask, alive=alive)

    def on_head_failure(self, state0, plan, view, alive):
        # Keep live heads; a dead head is replaced by the surviving member
        # with the best within-cluster aggregate link SNR.  Derived afresh
        # each round, so a recovered head resumes.
        return cl.reelect_heads(state0.plan if plan is None else plan,
                                view.link_snr, alive)

    def recluster(self, view, num_clusters: int, first: int):
        return cl.make_cluster_plan(view.link_snr, view.adjacency,
                                    num_clusters, first)


register_strategy("cwfl", CWFLStrategy(name="cwfl"))
