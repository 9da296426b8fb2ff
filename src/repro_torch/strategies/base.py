"""The Strategy protocol + registry (port of `repro.strategies.base`).

A :class:`Strategy` owns one aggregation algorithm's surface: offline
setup (``init``), the per-round rebuild of its state from a channel view
(``state_from_view``), the round's noise (``sync_noise``, drawn through
the draw seam), the sync round (``aggregate``), the receive side of a
masked round (``receive_mask``), the head-failure handoff
(``on_head_failure``), re-clustering (``recluster``) and the channel uses
a round costs (``channel_uses``).  A Monte-Carlo sweep runs its
trajectories together through the ``*_batch`` hooks (``init_batch``,
``aggregate_batch``): states stacked along a leading trajectory axis,
and the trajectories' clients stacked beside K.  Under a dynamic
scenario the sweep maps ``state_from_view``, ``on_head_failure``,
``recluster`` and ``receive_mask`` over its trajectories with
``torch.func.vmap`` (`repro_torch.utils.nest.nest_vmap`), so these hooks
must be pure functions of their tensors: no host sync, no Python branch
on a tensor's value.  The ``telemetry`` hook reports a round's internals
(`repro_torch.obs.telemetry`); a sweep calls it for each trajectory on
its own slices.  Every front door resolves a strategy by name through
:func:`get_strategy`.  Capability flags say which executors and which
scenario hooks apply to a strategy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Sequence

from repro_torch.core.cwfl import stack_states

State = Any   # strategy state (a dataclass of tensors)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One aggregation strategy: offline setup, per-round hooks and the
    sync round."""

    name: str
    #: Default FedProx µ_p of the local objective (paper §V); 0 = plain
    #: SGD.  ``FLConfig.mu_prox > 0`` overrides it (:meth:`effective_mu_prox`).
    mu_prox: float = 0.0

    #: Its sync runs as a client-axis collective, so ``run_rounds(...,
    #: shard="clients")`` can split the K clients over the ranks of a
    #: process group (`repro_torch.sim.sharded`).
    supports_client_sharding: ClassVar[bool] = False
    #: The round state depends on the connectivity graph
    #: (``ChannelView.adjacency``), not only on the link gains.
    needs_graph: ClassVar[bool] = False
    #: Power is water-filled from channel estimates, so imperfect CSI
    #: (`repro_torch.sim.processes.csi_perturbation`) perturbs it.
    water_fills: ClassVar[bool] = False
    #: The state carries a cluster plan that re-clustering
    #: (``Scenario.recluster_every``) and the head-failure handoff replace.
    reclusters: ClassVar[bool] = False

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None
             ) -> State:
        """Offline setup → State.  ``draws`` supplies the setup's random
        draws (`repro_torch.sim.draws.Draws`); ``cfg`` is the `FLConfig`;
        ``snr_db`` is the resolved overall SNR (``None`` keeps the
        topology's own noise budget)."""
        raise NotImplementedError

    def state_from_view(self, state0: State, view, noise_var, *,
                        csi=None, mask=None, plan=None, alive=None) -> State:
        """Rebuild the round state from a channel view
        (`repro_torch.sim.processes.ChannelView`).  ``state0`` is the
        :meth:`init` state; ``csi`` an optional (K,) water-filling-gain
        factor; ``mask`` the (K,) participation; ``plan`` a cluster plan
        replacing ``state0``'s (re-clustered or re-elected); ``alive`` the
        (K,) node-up vector of a fault scenario."""
        raise NotImplementedError

    def sync_noise(self, draws, round_: int, num_clients: int,
                   num_clusters: int, d: int):
        """The unit-normal noise one sync of round ``round_`` consumes,
        from ``draws`` (`repro_torch.sim.draws.Draws`), on the draws'
        device; :meth:`aggregate` takes it as ``noise``.  Default: none
        (a noiseless sync)."""
        del draws, round_, num_clients, num_clusters, d
        return None

    def aggregate(self, stacked_params, state: State, noise, mask=None,
                  alive=None):
        """One sync round on a K-stacked parameter tree with the round's
        pre-drawn unit-normal noise.  Returns ``(new_stacked, consensus)``.
        ``mask`` is the (K,) {0,1} participation (transmit side); ``alive``
        the (K,) node-up vector, which also engages the strategy's guards
        against dead rows and poisoned signals."""
        raise NotImplementedError

    def init_batch(self, topology, draws: Sequence, cfg,
                   trajectories: Sequence) -> State:
        """Offline setup of B trajectories, their states stacked in order:
        ``trajectories`` holds ``(i, snr_db)`` pairs, trajectory b set up
        from the seed whose draws are ``draws[i]`` at overall SNR
        ``snr_db`` (``None`` keeps the topology's noise).  A seed's
        trajectories share its draws, which are consumed once, as JAX's
        inner ``vmap`` over the SNR axis shares its keys.  Default:
        :meth:`init` once a trajectory, for a strategy whose setup draws
        nothing."""
        return stack_states([self.init(topology, draws[i], cfg, snr_db=snr)
                             for i, snr in trajectories])

    def aggregate_batch(self, stacked_params, state: State, noise,
                        mask=None, alive=None):
        """One sync of B stacked trajectories: ``stacked_params`` leaves
        (B·K, ...), trajectory b's clients at rows b·K .. b·K + K − 1;
        ``state`` stacked (:meth:`init_batch`, or :meth:`state_from_view`
        mapped over the trajectories); ``noise`` the :meth:`sync_noise` of
        each trajectory stacked along a leading B; ``mask`` and ``alive``
        (B, K), as :meth:`aggregate`'s.  Returns ``(new_stacked,
        consensus)``, the consensus leaves (B, ...)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no batched sync")

    def receive_mask(self, state: State, mask, alive=None):
        """(K,) receive-side participation of a masked round: which clients
        adopt the aggregate (1) and which keep their locally-trained params
        (0).  Nodes the aggregation forces present keep the aggregate they
        hold, if they are up.  ``None`` means the aggregate already holds
        the absences (decentralized's pruned graph): the engine then folds
        nothing on the receive side and never skips the sync.  Default:
        the mask itself."""
        del state, alive
        return mask

    def on_head_failure(self, state0: State, plan, view, alive):
        """Repair the round's infrastructure after node crashes, before
        :meth:`state_from_view`; called every round of a fault scenario.
        ``plan`` is the round's cluster plan, ``None`` for a strategy
        without one.  Default: nothing to repair, ``plan`` back."""
        del state0, view, alive
        return plan

    def recluster(self, view, num_clusters: int, first):
        """A new cluster plan from a channel view; ``first`` is K-means'
        first centre (a 0-d int64 tensor).  Called every
        ``Scenario.recluster_every`` rounds, and only if
        :attr:`reclusters`."""
        raise NotImplementedError(
            f"{type(self).__name__} has no cluster plan to rebuild")

    def channel_uses(self, num_clients: int,
                     num_clusters: Optional[int] = None, participants=None):
        """OTA channel uses (MAC slots) one sync round takes, the paper's
        Fig. 4 cost axis; ``participants`` is a masked round's count.
        Default: an orchestrator-free genie (FedAvg), zero."""
        del num_clients, num_clusters, participants
        return 0

    def telemetry(self, state: State, *, losses, stacked, new_stacked,
                  consensus, mask=None) -> dict:
        """The round's strategy internals: ``{"cluster_loss": (C',),
        "participants": (), "consensus_drift": (C',), "extras": {str:
        tensor}}``, shapes fixed across rounds.  ``losses`` is the engine's
        (K,) full-shard telemetry loss (a fresh forward on the locally
        trained params, never the round's minibatch losses);
        ``stacked``/``new_stacked`` the pre- and post-sync stacks;
        ``consensus`` the post-sync global model; ``mask`` the round's
        (K,) participation or ``None``.  It runs in the captured round: no
        host sync.  Default: one global
        site — mean loss, mask-summed participants, mean drift
        ‖θ_k − θ̄‖."""
        import torch

        from repro_torch.obs.telemetry import stacked_consensus_drift

        del state, stacked
        participants = (
            torch.full((), float(losses.shape[0]), dtype=torch.float32,
                       device=losses.device)
            if mask is None else torch.sum(mask).to(torch.float32))
        drift = torch.mean(stacked_consensus_drift(new_stacked, consensus))
        return {"cluster_loss": torch.mean(losses)[None],
                "participants": participants,
                "consensus_drift": drift[None],
                "extras": {}}

    def effective_mu_prox(self, cfg_mu: float) -> float:
        """FedProx µ_p of the local runner: an explicit ``FLConfig.mu_prox``
        > 0 wins, else the strategy's default."""
        return cfg_mu if cfg_mu > 0 else self.mu_prox


_REGISTRY: dict[str, Strategy] = {}


def register_strategy(name: str, strategy: Strategy) -> Strategy:
    """Register ``strategy`` under ``name``; a name is registered once."""
    if not isinstance(strategy, Strategy):
        raise TypeError(f"register_strategy needs a Strategy, got "
                        f"{type(strategy).__name__}")
    if name in _REGISTRY:
        raise ValueError(f"strategy {name!r} is already registered")
    _REGISTRY[name] = strategy
    return strategy


def get_strategy(name) -> Strategy:
    """Resolve a strategy by name (or pass a `Strategy` instance through)."""
    if isinstance(name, Strategy):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"choose from {available_strategies()}") from None


def available_strategies() -> list[str]:
    """Sorted names of every registered strategy."""
    return sorted(_REGISTRY)
