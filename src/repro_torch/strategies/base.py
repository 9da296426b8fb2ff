"""The Strategy protocol + registry (port of `repro.strategies.base`).

A :class:`Strategy` owns one aggregation algorithm's surface: offline
setup (``init``), the per-round rebuild of its state from a channel view
(``state_from_view``), the sync round (``aggregate``), the receive side of
a masked round (``receive_mask``), the head-failure handoff
(``on_head_failure``) and re-clustering (``recluster``).  Every front door
resolves a strategy by name through :func:`get_strategy`.  A capability
flag says which executors a strategy supports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional

State = Any   # strategy state (a dataclass of tensors)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One aggregation strategy: offline setup, per-round hooks and the
    sync round."""

    name: str

    #: Its sync runs as a client-axis collective, so ``run_rounds(...,
    #: shard="clients")`` can split the K clients over the ranks of a
    #: process group (`repro_torch.sim.sharded`).
    supports_client_sharding: ClassVar[bool] = False

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

    def aggregate(self, stacked_params, state: State, noise, mask=None,
                  alive=None):
        """One sync round on a K-stacked parameter tree with the round's
        pre-drawn unit-normal noise.  Returns ``(new_stacked, consensus)``.
        ``mask`` is the (K,) {0,1} participation (transmit side); ``alive``
        the (K,) node-up vector, which also engages the strategy's guards
        against dead rows and poisoned signals."""
        raise NotImplementedError

    def receive_mask(self, state: State, mask, alive=None):
        """(K,) receive-side participation of a masked round: which clients
        adopt the aggregate (1) and which keep their locally-trained params
        (0).  Nodes the aggregation forces present keep the aggregate they
        hold, if they are up."""
        raise NotImplementedError

    def on_head_failure(self, state0: State, plan, view, alive):
        """Repair the round's infrastructure after node crashes, before
        :meth:`state_from_view`; called every round of a fault scenario."""
        raise NotImplementedError

    def recluster(self, view, num_clusters: int, first: int):
        """A new cluster plan from a channel view; ``first`` is K-means'
        first centre.  Called every ``Scenario.recluster_every`` rounds."""
        raise NotImplementedError


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
