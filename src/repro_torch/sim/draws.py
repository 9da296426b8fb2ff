"""The random draws of one FL run, behind one seam.

JAX and torch can never share a random stream (threefry against Philox),
so everything random that a run consumes comes from a :class:`Draws`
object: K-means' first centre, the initial params, and each round's
minibatch indices and phase-1/phase-2 unit normals.  `TorchDraws` draws
them from ``torch.Generator``s; a test can pass an object that replays the
JAX package's draws instead.

The streams keep the JAX engine's key structure
(`repro.sim.engine` ``prepare``): one generator each for the offline
state, the initial params and the rounds; within a round the local draws
come before the aggregation's, phase 1 before phase 2.
"""
from __future__ import annotations

from typing import Callable, Protocol

import torch


class Draws(Protocol):
    def kmeans_first(self, num_clients: int) -> int:
        """K-means' first centre, in [0, num_clients)."""

    def init_params(self, init_fn: Callable) -> dict:
        """The initial (unstacked) params."""

    def batch_indices(self, round_: int, num_clients: int, steps: int,
                      batch: int, n_k: int) -> torch.Tensor:
        """(K, steps, batch) int64 minibatch indices into each shard."""

    def phase_noise(self, round_: int, num_clusters: int, d: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two (C, d) f32 unit-normal matrices: phase 1, phase 2."""


class TorchDraws:
    """Draws from ``torch.Generator``s on ``device``, seeded from ``seed``:
    three generators (offline state, initial params, rounds) whose seeds
    come from a generator seeded with ``seed``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        seeds = torch.randint(2 ** 62, (3,),
                              generator=torch.Generator().manual_seed(seed))
        self._state, self._init, self._rounds = (
            torch.Generator(self.device).manual_seed(int(s)) for s in seeds)

    def kmeans_first(self, num_clients: int) -> int:
        return int(torch.randint(num_clients, (), generator=self._state,
                                 device=self.device))

    def init_params(self, init_fn: Callable) -> dict:
        return init_fn(self._init)

    def batch_indices(self, round_: int, num_clients: int, steps: int,
                      batch: int, n_k: int) -> torch.Tensor:
        del round_   # the rounds' generator is consumed in round order
        return torch.randint(n_k, (num_clients, steps, batch),
                             generator=self._rounds, device=self.device)

    def phase_noise(self, round_: int, num_clusters: int, d: int):
        del round_
        return tuple(torch.randn(num_clusters, d, generator=self._rounds,
                                 device=self.device) for _ in range(2))
