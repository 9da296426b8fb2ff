"""The Strategy protocol + registry (port of `repro.strategies.base`).

A :class:`Strategy` owns one aggregation algorithm's surface: offline
setup (``init``) and the sync round (``aggregate``).  Every front door
resolves a strategy by name through :func:`get_strategy`.  This slice
ports the static-scenario part of the protocol; the per-round rebuild,
receive-side and fault hooks come with the scenario slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

State = Any   # strategy state (a dataclass of tensors)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One aggregation strategy: offline setup and the sync round."""

    name: str

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None
             ) -> State:
        """Offline setup → State.  ``draws`` supplies the setup's random
        draws (`repro_torch.sim.draws.Draws`); ``cfg`` is the `FLConfig`;
        ``snr_db`` is the resolved overall SNR (``None`` keeps the
        topology's own noise budget)."""
        raise NotImplementedError

    def aggregate(self, stacked_params, state: State, noise):
        """One sync round on a K-stacked parameter tree with the round's
        pre-drawn unit-normal noise.  Returns ``(new_stacked, consensus)``.
        """
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
