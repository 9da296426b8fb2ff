"""The random draws of one FL run, behind one seam.

JAX and torch can never share a random stream (threefry against Philox),
so everything random that a run consumes comes from a :class:`Draws`
object: K-means' first centre, the initial params, each round's minibatch
indices and sync noise (CWFL's phase-1/phase-2 unit normals, or the one
matrix of a baseline's sync), and a dynamic scenario's draws (channel
process, CSI error, schedule, re-clustering, faults).
`TorchDraws` draws them from ``torch.Generator``s; a test can pass an
object that replays the JAX package's draws instead.

The streams keep the JAX engine's key structure
(`repro.sim.engine` ``prepare``): one generator each for the offline
state, the initial params and the rounds; within a round the local draws
come before the aggregation's, phase 1 before phase 2.  The scenario
draws come from a stream of their own, as JAX folds them out of the run's
key apart from the rest, so a static run draws what it drew before there
were scenarios.  The seam hands out uniforms and normals, never decisions:
the processes decide (`u < p` for a Bernoulli draw) themselves.

A checkpointed run saves the draws' state (``state``/``set_state``):
unlike JAX's keys, a round's torch draws cannot be rebuilt from its
index, so a resume restores the generators where the checkpoint left
them.  The draws are taken outside the captured round, so their state
can be read between replays.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Protocol, Sequence

import torch

from repro_torch.sim.faults import FaultDraws
from repro_torch.sim.processes import ChannelDraws
from repro_torch.utils.nest import nest_stack


class Draws(Protocol):
    def kmeans_first(self, num_clients: int) -> torch.Tensor:
        """K-means' first centre, a 0-d int64 tensor in [0, num_clients)."""

    def init_params(self, init_fn: Callable) -> dict:
        """The initial (unstacked) params."""

    def batch_indices(self, round_: int, num_clients: int, steps: int,
                      batch: int, n_k: int) -> torch.Tensor:
        """(K, steps, batch) int64 minibatch indices into each shard."""

    def phase_noise(self, round_: int, num_clusters: int, d: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two (C, d) f32 unit-normal matrices: phase 1, phase 2."""

    def sync_noise(self, round_: int, rows: int, d: int) -> torch.Tensor:
        """One (rows, d) f32 unit-normal matrix, a baseline's sync noise
        (COTAF: one row; decentralized: K), at the place of the round's
        aggregation draws."""

    def channel_init(self, num_clients: int) -> torch.Tensor:
        """(K, 2) uniforms for the channel process's first waypoints."""

    def channel_step(self, round_: int, num_clients: int) -> ChannelDraws:
        """The channel step's normals and waypoint uniforms."""

    def csi_normals(self, round_: int, num_clients: int) -> torch.Tensor:
        """(K,) unit normals of the CSI error."""

    def schedule_uniforms(self, round_: int,
                          num_clients: int) -> torch.Tensor:
        """(K,) uniforms of the schedule's dropout."""

    def recluster_first(self, round_: int, num_clients: int) -> torch.Tensor:
        """The re-clustering K-means' first centre, a 0-d int64 tensor in
        [0, num_clients)."""

    def fault_uniforms(self, round_: int, num_clients: int) -> FaultDraws:
        """The fault chains' six uniform draws."""

    def state(self) -> dict[str, torch.Tensor]:
        """What a resumed run needs to draw on where this one stands (a
        checkpoint saves it); empty for draws indexed by round."""

    def set_state(self, state: dict[str, torch.Tensor]) -> None:
        """Continue from a :meth:`state`."""


class TorchDraws:
    """Draws from ``torch.Generator``s on ``device``, seeded from ``seed``:
    four generators (offline state, initial params, rounds, scenario)
    whose seeds come from a generator seeded with ``seed``.  Each is
    consumed in call order, so the ``round_`` arguments go unused."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        seeder = torch.Generator().manual_seed(seed)
        seeds = torch.randint(2 ** 62, (3,), generator=seeder)
        self._state, self._init, self._rounds = (
            torch.Generator(self.device).manual_seed(int(s)) for s in seeds)
        self._scenario = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (), generator=seeder)))

    def kmeans_first(self, num_clients: int) -> torch.Tensor:
        return torch.randint(num_clients, (), generator=self._state,
                             device=self.device)

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

    def sync_noise(self, round_: int, rows: int, d: int) -> torch.Tensor:
        del round_
        return torch.randn(rows, d, generator=self._rounds,
                           device=self.device)

    def _uniform(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._scenario,
                          device=self.device)

    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._scenario,
                           device=self.device)

    def channel_init(self, num_clients: int) -> torch.Tensor:
        return self._uniform(num_clients, 2)

    def channel_step(self, round_: int, num_clients: int) -> ChannelDraws:
        K = num_clients
        return ChannelDraws(fade_re=self._normal(K, K),
                            fade_im=self._normal(K, K),
                            shadow=self._normal(K, K),
                            waypoints=self._uniform(K, 2))

    def csi_normals(self, round_: int, num_clients: int) -> torch.Tensor:
        return self._normal(num_clients)

    def schedule_uniforms(self, round_: int,
                          num_clients: int) -> torch.Tensor:
        return self._uniform(num_clients)

    def recluster_first(self, round_: int, num_clients: int) -> torch.Tensor:
        return torch.randint(num_clients, (), generator=self._scenario,
                             device=self.device)

    def fault_uniforms(self, round_: int, num_clients: int) -> FaultDraws:
        K = num_clients
        return FaultDraws(crash=self._uniform(K), recover=self._uniform(K),
                          enter=self._uniform(), leave=self._uniform(),
                          hit=self._uniform(K), fade=self._uniform())

    def _generators(self) -> dict[str, torch.Generator]:
        return {"state": self._state, "init": self._init,
                "rounds": self._rounds, "scenario": self._scenario}

    def state(self) -> dict[str, torch.Tensor]:
        """Each generator's ``get_state()`` (a CUDA generator's: its seed
        and Philox offset), as uint8 tensors on the CPU."""
        return {k: g.get_state() for k, g in self._generators().items()}

    def set_state(self, state: dict[str, torch.Tensor]) -> None:
        for k, g in self._generators().items():
            g.set_state(state[k])


class RoundDraws(NamedTuple):
    """Everything random one round consumes, taken before the round (the
    counterpart of the JAX engine's per-round ``scan_xs``: ``rkey`` for the
    local and sync draws, ``skey`` for the scenario's).  A field is
    ``None`` where the round draws nothing of its kind."""

    idx: torch.Tensor                       # (K, steps, batch) int64
    noise: Any                              # the strategy's sync noise
    channel: Optional[ChannelDraws] = None
    schedule: Optional[torch.Tensor] = None  # (K,) uniforms
    faults: Optional[FaultDraws] = None
    csi: Optional[torch.Tensor] = None       # (K,) unit normals
    recluster: Optional[torch.Tensor] = None  # 0-d int64 first centre


def take_round(draws: Draws, t: int, *, strategy, scenario, num_clients: int,
               steps: int, batch: int, n_k: int, num_clusters: int, d: int,
               recluster: bool = False) -> RoundDraws:
    """Round ``t``'s draws, in the order the round consumes them: from the
    rounds' stream the minibatch indices, then the strategy's sync noise;
    from the scenario's stream the channel step, the schedule's uniforms,
    the fault uniforms, the CSI normals and, when ``recluster`` (a round
    with ``t % recluster_every == 0`` of a strategy with a cluster plan),
    the re-clustering K-means' first centre.  A kind the scenario does not
    draw stays ``None``."""
    K, sc = num_clients, scenario
    idx = draws.batch_indices(t, K, steps, batch, n_k)
    noise = strategy.sync_noise(draws, t, K, num_clusters, d)
    channel = (draws.channel_step(t, K) if sc.channel.evolves_geometry
               else None)
    schedule = (None if sc.schedule.is_trivial
                else draws.schedule_uniforms(t, K))
    faults = None if sc.faults.is_trivial else draws.fault_uniforms(t, K)
    csi = (draws.csi_normals(t, K) if strategy.water_fills
           and sc.channel.csi_error_std > 0 else None)
    first = draws.recluster_first(t, K) if recluster else None
    return RoundDraws(idx=idx, noise=noise, channel=channel,
                      schedule=schedule, faults=faults, csi=csi,
                      recluster=first)


def take_rounds(draws: Sequence[Draws], t: int, **kwargs) -> RoundDraws:
    """Round ``t``'s draws of several seeds (a Monte-Carlo sweep's): each
    seed's :func:`take_round` (``kwargs`` as its), in the loop's order
    within the seed, stacked along a leading seed axis."""
    return nest_stack([take_round(dr, t, **kwargs) for dr in draws])
