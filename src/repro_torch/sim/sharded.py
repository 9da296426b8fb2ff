"""Device-parallel execution of the engine (port of `repro.sim.sharded`)
over a ``torch.distributed`` process group, one process a rank.

* ``monte_carlo_sharded`` (``run_monte_carlo(..., shard="mc")``): the
  trajectory grid is flattened seed-major, padded up to the group's size
  by repeating its last entry, and each rank runs its contiguous chunk as
  one batched sweep (`repro_torch.sim.engine._run_sweep`); the metrics
  are gathered once at the end.  Trajectories are independent, so the
  sweep needs no collective before the gather.

* ``run_rounds_client_sharded`` (``run_rounds(..., shard="clients")``):
  within ONE large-K trajectory the stacked client axis is split over the
ranks of a ``torch.distributed`` process group, one process a rank: each
rank trains its K/n clients locally, and the CWFL sync runs as a two-phase
collective in the mold of
`repro_torch.dist.fl_integration.hierarchical_ota_allreduce` — the
per-cluster OTA sums ride an ``all_reduce`` (phase 1), the (C, C) consensus
mix is rank-local (phase 2), and each rank applies only its own rows of
the phase-3 downlink.  Every rank draws what the unsharded run draws — all
K clients' minibatch indices, of which it trains on its own rows, and the
phase noise — so every rank sees the same channel realization.

Parity with the unsharded engine is to sum-reassociation tolerance, not
bitwise: the ``all_reduce`` re-associates Σ_k Ã_ck θ_k across ranks, the
precoding powers are summed over the flat vector rather than leaf by leaf,
and the round's products run as plain ``torch.matmul`` (as in JAX, where
they sit outside any Pallas kernel) rather than the fused round kernel.

The client-sharded round runs in a loop (``mode="loop"``); its capture
over NCCL is not ported yet (ROADMAP §1 item 3, what is left).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core import cwfl
from repro_torch.core.topology import Topology
from repro_torch.models.small import accuracy
from repro_torch.sim.draws import Draws, TorchDraws
from repro_torch.sim.engine import _full_f32, _history, _prepare, _run_sweep
from repro_torch.sim.scenarios import Scenario, get_scenario
from repro_torch.strategies import get_strategy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_size


# ---------------------------------------------------------------------------
# Trajectory-parallel Monte-Carlo (shard="mc").
# ---------------------------------------------------------------------------

def _pad_to(xs: list, n: int) -> list:
    """``xs`` padded to length ``n`` by repeating its last entry (the
    padded trajectories are real but redundant work, sliced off after the
    gather: a uniform chunk a rank beats a ragged one)."""
    return list(xs) + [xs[-1]] * max(n - len(xs), 0)


def make_sharded_sweep_fn(init_fn: Callable, apply_fn: Callable,
                          loss_fn: Callable, topology: Topology,
                          xs: torch.Tensor, ys: torch.Tensor,
                          x_test: torch.Tensor, y_test: torch.Tensor, cfg,
                          strategy, n_pad: int, group=None,
                          draws_of: Optional[Callable] = None, device=None,
                          timers=None) -> Callable:
    """The sweep over ``n_pad`` flattened trajectories (a multiple of the
    group's size): ``f(seed_flat, snr_flat) -> (loss, acc)``, each
    (n_pad, T) on every rank.  Rank r runs trajectories
    [r·n_pad/n, (r+1)·n_pad/n) as one batch on ``device`` (the seeds of
    its chunk drawn by ``draws_of(seed)``, default `TorchDraws`; a seed's
    trajectories share one `Draws`), then the chunks are gathered."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if n_pad % world:
        raise ValueError(f"{n_pad} trajectories do not divide over the "
                         f"{world} ranks of the process group")
    chunk = n_pad // world
    device = resolve_device(device)

    def sweep(seed_flat: Sequence[int], snr_flat: Sequence):
        mine = slice(rank * chunk, (rank + 1) * chunk)
        seeds = list(dict.fromkeys(seed_flat[mine]))
        draws = [draws_of(s) if draws_of is not None
                 else TorchDraws(s, device) for s in seeds]
        loss, acc = _run_sweep(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, strategy, seeds, [seeds.index(s) for s in seed_flat[mine]],
            snr_flat[mine], draws, device, timers)
        out = torch.stack([loss, acc])                    # (2, chunk, T)
        gathered = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(gathered, out, group=group)
        both = torch.cat(gathered, dim=1)
        return both[0], both[1]

    return sweep


def monte_carlo_sharded(init_fn: Callable, apply_fn: Callable,
                        loss_fn: Callable, topology: Topology,
                        xs: torch.Tensor, ys: torch.Tensor,
                        x_test: torch.Tensor, y_test: torch.Tensor, cfg,
                        strategy, seeds: Sequence[int],
                        snr_grid: Optional[Sequence[float]], group=None,
                        timers=None, draws: Optional[Sequence] = None,
                        device=None):
    """The seeds × ``snr_grid`` sweep (``snr_grid`` ``None``: the seeds at
    ``cfg.snr_db``) split over the ranks of ``group``: flattened
    seed-major (pair i = (seeds[i // G], grid[i % G]), the order of the
    unsharded sweep), padded to the group's size, a chunk a rank
    (:func:`make_sharded_sweep_fn`).  ``draws``: one `Draws` for each of
    ``seeds``, or ``None``.  Called by every rank; returns ``(loss,
    acc)``, each (S·G, T), the same on every rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "shard='mc' runs over a torch.distributed process group, one "
            "process a rank: call torch.distributed.init_process_group "
            "first")
    world = dist.get_world_size(group)
    if snr_grid is None:
        seed_flat, snr_flat = list(seeds), [cfg.snr_db] * len(seeds)
    else:
        seed_flat = [s for s in seeds for _ in snr_grid]
        snr_flat = list(snr_grid) * len(seeds)
    n = len(seed_flat)
    n_pad = -(-n // world) * world
    by_seed = dict(zip(seeds, draws)) if draws is not None else None
    sweep = make_sharded_sweep_fn(
        init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test, cfg,
        strategy, n_pad, group=group,
        draws_of=None if by_seed is None else by_seed.__getitem__,
        device=device, timers=timers)
    loss, acc = sweep(_pad_to(seed_flat, n_pad), _pad_to(snr_flat, n_pad))
    return loss[:n], acc[:n]


# ---------------------------------------------------------------------------
# Client-parallel execution of one trajectory (shard="clients").
# ---------------------------------------------------------------------------

def _client_sharded_sync(stacked_local, state: cwfl.CWFLState, noise,
                         group=None):
    """One CWFL sync with the K clients split over ``group``; this rank
    holds ``stacked_local`` (leaves (K/n, ...)), the clients
    ``rank·K/n ... (rank+1)·K/n - 1``.

    ``noise``: ``(unit1, unit2)``, two (C, d) unit-normal matrices in the
    flat leaf order, the same on every rank.  Returns ``(new_local,
    consensus)``; the consensus is the same on every rank."""
    leaves, treedef = tree_flatten(stacked_local)
    kl = leaves[0].shape[0]
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    flat = cwfl._flat_pack(leaves, kl)
    d = flat.shape[1]

    # Eq. (5) precoding needs every client's per-channel-use power: gather
    # the (K/n,) local powers into the global (K,) vector on every rank.
    sq_local = torch.sum(flat * flat, dim=1)
    gathered = [torch.empty_like(sq_local) for _ in range(world)]
    dist.all_gather(gathered, sq_local, group=group)
    A, eff_std1, B, kappa, m_back = cwfl.round_coefficients(
        state, mean_sq=torch.cat(gathered) / d)
    rows = slice(rank * kl, (rank + 1) * kl)
    unit1, unit2 = noise

    # Phase 1 (eq. 8): the OTA MAC — per-cluster sums over all K clients
    # ride the collective; the receiver noise is shared.
    theta_tilde = A[:, rows] @ flat                                # (C, d)
    dist.all_reduce(theta_tilde, op=dist.ReduceOp.SUM, group=group)
    theta_tilde = theta_tilde + eff_std1[:, None] * unit1

    # Phase 2 (eq. 9 / lemma 2): the (C, C) mix, rank-local.
    theta_bar = B @ theta_tilde + kappa[:, None] * unit2

    # Phase 3: the error-free downlink, this rank's clients only.
    new_flat = m_back[rows] @ theta_bar                            # (K/n, d)
    cons_flat = torch.mean(theta_bar, dim=0)                       # (d,)
    return cwfl._flat_unpack(new_flat, cons_flat, leaves, treedef, kl)


def run_rounds_client_sharded(init_fn: Callable, apply_fn: Callable,
                              loss_fn: Callable, topology: Topology,
                              xs: torch.Tensor, ys: torch.Tensor,
                              x_test: torch.Tensor, y_test: torch.Tensor,
                              cfg, scenario: Union[Scenario, str, None] = None,
                              group=None, progress: Optional[Callable] = None,
                              draws: Optional[Draws] = None, device=None, *,
                              telemetry: bool = False,
                              checkpoint_dir: Optional[str] = None,
                              resume: bool = False,
                              stop_after: Optional[int] = None,
                              stream=None) -> dict[str, Any]:
    """One trajectory with the K clients split over the ranks of ``group``
    (``None``: the default process group): per-rank local training on its
    K/n clients (rows of the full ``xs``/``ys`` every rank is given) and
    the collective CWFL sync, round after round.  Called by every rank;
    returns the same history on every rank, with the same keys as
    `repro_torch.sim.engine.run_rounds`.

    Static CWFL scenarios only: masking and re-clustering have not been
    taught the sharded sync.  ``progress(r, loss, acc)`` runs on every
    rank.  ``telemetry``, ``checkpoint_dir``/``resume``/``stop_after`` and
    ``stream`` are not ported (ROADMAP §1 item 5) and raise."""
    for name, value in (("telemetry", telemetry),
                        ("checkpoint_dir", checkpoint_dir),
                        ("resume", resume), ("stop_after", stop_after),
                        ("stream", stream)):
        if value not in (None, False):
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP §1 item 5: "
                f"observability and checkpoints)")
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    scenario = scenario or Scenario()
    if not scenario.is_static:
        raise NotImplementedError(
            "shard='clients' supports static scenarios only (dynamic "
            "masking/re-clustering have not been taught the sharded sync)")
    strategy = get_strategy(cfg.strategy)
    if not strategy.supports_client_sharding:
        raise NotImplementedError(
            f"shard='clients' needs a strategy whose sync is implemented "
            f"as a client-axis collective (supports_client_sharding); "
            f"{type(strategy).__name__} (strategy {strategy.name!r}) has "
            f"none")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "shard='clients' runs over a torch.distributed process group, "
            "one process a rank: call torch.distributed."
            "init_process_group first")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    K, n_k = int(xs.shape[0]), int(xs.shape[1])
    if K % world:
        raise ValueError(f"K={K} clients must divide over the {world} ranks "
                         f"of the process group")
    kl = K // world
    rows = slice(rank * kl, (rank + 1) * kl)

    device = resolve_device(device)
    with _full_f32():
        topology = topology.to(device)
        xs_l, ys_l = xs[rows].to(device), ys[rows].to(device)
        x_ev = x_test[: cfg.eval_samples].to(device)
        y_ev = y_test[: cfg.eval_samples].to(device)
        draws = draws if draws is not None else TorchDraws(cfg.seed, device)
        state, consensus, optimizer, local_run, steps = _prepare(
            init_fn, loss_fn, topology, cfg, strategy, draws, n_k, device)
        stacked = tree_map(lambda x: x.expand((kl,) + x.shape).clone(),
                           consensus)
        opt_state = optimizer.init(stacked)
        d = tree_size(consensus)

        losses, accs = [], []
        for t in range(cfg.rounds):
            # The global draws, of which this rank takes its clients' rows.
            idx = draws.batch_indices(t, K, steps, cfg.batch_size, n_k)
            trained, opt_state, client_loss = local_run(
                stacked, opt_state, xs_l, ys_l, idx[rows].to(device))
            unit1, unit2 = draws.phase_noise(t, cfg.num_clusters, d)
            with torch.no_grad():
                stacked, consensus = _client_sharded_sync(
                    trained, state, (unit1.to(device), unit2.to(device)),
                    group)
                acc = accuracy(apply_fn(consensus, x_ev), y_ev)
                total = torch.sum(client_loss).reshape(1)
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            loss = total[0] / K
            losses.append(loss)
            accs.append(acc)
            if progress is not None:
                progress(t + 1, float(loss), float(acc))
        return _history(losses, accs, consensus)
