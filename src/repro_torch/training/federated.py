"""The paper-protocol front door (`run_federated` + `FLConfig`), port of
`repro.training.federated`.

One round = E local epochs at every client in parallel, then one
synchronization under the selected aggregation strategy; the round loop
lives in `repro_torch.sim.engine`.  ``STRATEGIES`` is JAX's deprecated
read-only ``name -> (setup, aggregate)`` view of the strategy registry.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Optional

import torch

from repro_torch.core.topology import Topology
from repro_torch.strategies import available_strategies, get_strategy


class _DeprecatedStrategies(Mapping):
    """Read-only ``name -> (setup, aggregate)`` view of the strategy
    registry, as JAX keeps it for pre-Strategy-API callers.  Every access
    (not the import) warns: new code resolves
    `repro_torch.strategies.get_strategy` and calls the `Strategy`.  The
    pair takes what the port's strategies take: ``setup(topology, draws,
    *, num_clusters=3, snr_db=None)`` with the setup's draws
    (`repro_torch.sim.draws`) where JAX takes a key, and
    ``aggregate(params, state, noise)`` with the round's unit normals."""

    @staticmethod
    def _warn():
        warnings.warn(
            "repro_torch.training.STRATEGIES is deprecated; use "
            "repro_torch.strategies.get_strategy(name) and the Strategy "
            "object (init/aggregate) instead", DeprecationWarning,
            stacklevel=3)

    def __getitem__(self, name):
        self._warn()
        strategy = get_strategy(name)

        def setup(topology, draws, *, num_clusters=3, snr_db=None, **_):
            cfg = FLConfig(strategy=strategy.name, num_clusters=num_clusters)
            return strategy.init(topology, draws, cfg, snr_db=snr_db)

        def aggregate(params, state, noise):
            return strategy.aggregate(params, state, noise)

        return setup, aggregate

    def __iter__(self):
        self._warn()
        return iter(available_strategies())

    def __len__(self):
        self._warn()
        return len(available_strategies())


STRATEGIES = _DeprecatedStrategies()


@dataclasses.dataclass(frozen=True)
class FLConfig:
    strategy: str = "cwfl"           # resolved via repro_torch.strategies
    rounds: int = 70                 # paper: 70-80 communication rounds
    local_epochs: int = 1            # E
    batch_size: int = 64             # paper: 64 (MNIST) / 32 (CIFAR)
    lr: float = 1e-3                 # paper: 0.001
    num_clusters: int = 3            # paper: 3 optimal
    snr_db: Optional[float] = 40.0   # paper: overall SNR 40 dB
    mu_prox: float = 0.0             # FedProx µ_p (0 = the strategy's default)
    eval_samples: int = 2048
    seed: int = 0


def run_federated(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
                  topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
                  x_test: torch.Tensor, y_test: torch.Tensor,
                  cfg: FLConfig, progress: Optional[Callable] = None,
                  scenario=None, topo_cfg=None, draws=None,
                  device=None, mode: Optional[str] = None,
                  timers=None) -> dict[str, Any]:
    """Run FL; returns a history dict with per-round test accuracy/loss as
    Python floats.  ``xs, ys``: stacked client shards (K, N_k, ...).
    ``scenario``/``topo_cfg`` opt into the scenario dynamics (a `Scenario`
    or a registered name, and the `TopologyConfig` that made
    ``topology``).  ``device=None`` runs on the GPU.  The engine runs the
    scanned trajectory, or its loop when a live ``progress(r, loss,
    acc)`` callback is given, as the JAX package's ``run_federated``
    chooses; ``mode`` ("scan" or "loop") overrides the choice.  See
    `repro_torch.sim.engine.run_rounds` for ``scenario``, ``draws``,
    ``mode`` and ``timers``."""
    from repro_torch.sim.engine import run_rounds  # deferred: sim imports training

    if mode is None:
        mode = "loop" if progress is not None else "scan"
    h = run_rounds(init_fn, apply_fn, loss_fn, topology, xs, ys, x_test,
                   y_test, cfg, scenario=scenario, topo_cfg=topo_cfg,
                   mode=mode, progress=progress, draws=draws, device=device,
                   timers=timers)
    history = {
        "round": [int(r) for r in h["round"]],
        "train_loss": h["train_loss"].tolist(),
        "test_acc": h["test_acc"].tolist(),
    }
    history["final_params"] = h["final_params"]
    history["avg_acc"] = float(h["avg_acc"])
    history["final_acc"] = history["test_acc"][-1]
    if "scenario" in h:
        history["scenario"] = {k: v.tolist() for k, v in h["scenario"].items()}
    return history
