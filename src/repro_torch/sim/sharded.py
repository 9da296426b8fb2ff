"""Device-parallel execution of the engine (port of `repro.sim.sharded`)
over a ``torch.distributed`` process group, one process a rank.

* ``monte_carlo_sharded`` (``run_monte_carlo(..., shard="mc")``): the
  trajectory grid is flattened seed-major, padded up to the group's size
  by repeating its last entry, and each rank runs its contiguous chunk as
  one batched sweep (`repro_torch.sim.engine._run_sweep`), under any
  registered scenario; the metrics, a dynamic scenario's records and the
  telemetry are gathered once at the end.  Trajectories are independent,
  so the sweep needs no collective before the gather.  A stream is scoped
  to rank 0's chunk (`RoundStream.scope_to_trajectories`), JAX's "rank-0
  emit".

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

The client-sharded round is one ``body(carry, draws, t)``, as the
unsharded engine's: ``mode="loop"`` runs it eagerly, ``mode="scan"`` (the
default) through the engine's `_Replayer` — on a CUDA device an eager
first round (which creates the NCCL communicator, on the capture's
stream), then one CUDA graph a round with the round's collectives inside
it; on the CPU (``gloo``) every round eagerly.  Its telemetry rides the
same round: the per-cluster losses one more ``all_reduce``, each head's
drift computed on the rank that owns it and summed over the ranks, the
rest from the sync's replicated internals (JAX's ``_CLIENT_TELE_EXTRAS``).
Its checkpoints hold the whole carry, its rows gathered over the ranks:
rank 0 alone writes them, every rank loads one and keeps its own rows.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core import cwfl
from repro_torch.core.topology import Topology
from repro_torch.models.small import accuracy
from repro_torch.obs.stream import LiveTap, emit_sweep
from repro_torch.obs.telemetry import (RoundTelemetry, init_ledger,
                                       per_client_dim,
                                       stacked_consensus_drift)
from repro_torch.sim.draws import Draws, RoundDraws, TorchDraws, take_round
from repro_torch.sim.engine import (_Checkpoints, _history, _on, _phase,
                                    _prepare, _reference_numerics,
                                    _run_sweep, check_obs_args,
                                    checkpoint_manifest, scan_rounds)
from repro_torch.dist.sharding_rules import (client_specs, shard_size,
                                             trajectory_specs)
from repro_torch.sim.scenarios import Scenario, get_scenario
from repro_torch.strategies import get_strategy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.nest import nest_map
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_size


# ---------------------------------------------------------------------------
# Trajectory-parallel Monte-Carlo (shard="mc").
# ---------------------------------------------------------------------------

def _pad_to(xs: list, n: int) -> list:
    """``xs`` padded to length ``n`` by repeating its last entry (the
    padded trajectories are real but redundant work, sliced off after the
    gather: a uniform chunk a rank beats a ragged one)."""
    return list(xs) + [xs[-1]] * max(n - len(xs), 0)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis, in rank
    order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def make_sharded_sweep_fn(init_fn: Callable, apply_fn: Callable,
                          loss_fn: Callable, topology: Topology,
                          xs: torch.Tensor, ys: torch.Tensor,
                          x_test: torch.Tensor, y_test: torch.Tensor, cfg,
                          scenario: Scenario, topo_cfg, strategy, n_pad: int,
                          group=None, draws_of: Optional[Callable] = None,
                          device=None, timers=None,
                          telemetry: bool = False) -> Callable:
    """The sweep over ``n_pad`` flattened trajectories (a multiple of the
    group's size): ``f(seed_flat, snr_flat) -> (loss, acc, records,
    telemetry)``, loss and accuracy (n_pad, T), a dynamic scenario's
    records (n_pad, T[, C]) or ``None`` and the `RoundTelemetry` (leading
    n_pad, T) or ``None``, on every rank.  Rank r runs trajectories
    [r·n_pad/n, (r+1)·n_pad/n) as one batch on ``device`` (the seeds of
    its chunk drawn by ``draws_of(seed)``, default `TorchDraws`; a seed's
    trajectories share one `Draws`), then the chunks are gathered."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    # The chunk a rank runs, from the dist rules (JAX's shard_map in-spec).
    mesh = {"mc": world}
    spec = trajectory_specs(torch.empty(n_pad, device="meta"), mesh)
    if spec[0] is None:
        raise ValueError(f"{n_pad} trajectories do not divide over the "
                         f"{world} ranks of the process group")
    chunk = shard_size(spec, 0, n_pad, mesh)
    device = resolve_device(device)

    def sweep(seed_flat: Sequence[int], snr_flat: Sequence):
        mine = slice(rank * chunk, (rank + 1) * chunk)
        seeds = list(dict.fromkeys(seed_flat[mine]))
        draws = [draws_of(s) if draws_of is not None
                 else TorchDraws(s, device) for s in seeds]
        loss, acc, records, tele = _run_sweep(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, scenario, topo_cfg, strategy, seeds,
            [seeds.index(s) for s in seed_flat[mine]], snr_flat[mine],
            draws, device, timers, telemetry=telemetry)
        if records is not None:
            records = {k: _gather_rows(v, group)
                       for k, v in sorted(records.items())}
        if tele is not None:
            tele = nest_map(lambda x: _gather_rows(x, group), tele)
        return (_gather_rows(loss, group), _gather_rows(acc, group), records,
                tele)

    return sweep


def monte_carlo_sharded(init_fn: Callable, apply_fn: Callable,
                        loss_fn: Callable, topology: Topology,
                        xs: torch.Tensor, ys: torch.Tensor,
                        x_test: torch.Tensor, y_test: torch.Tensor, cfg,
                        scenario: Scenario, topo_cfg, strategy,
                        seeds: Sequence[int],
                        snr_grid: Optional[Sequence[float]], group=None,
                        timers=None, draws: Optional[Sequence] = None,
                        device=None, telemetry: bool = False, stream=None):
    """The seeds × ``snr_grid`` sweep (``snr_grid`` ``None``: the seeds at
    ``cfg.snr_db``) under ``scenario`` split over the ranks of ``group``:
    flattened seed-major (pair i = (seeds[i // G], grid[i % G]), the
    order of the unsharded sweep), padded to the group's size, a chunk a
    rank (:func:`make_sharded_sweep_fn`).  ``draws``: one `Draws` for each
    of ``seeds``, or ``None``.  Called by every rank; returns ``(loss,
    acc, records, telemetry)``, loss and accuracy (S·G, T), the records
    (S·G, T[, C]) or ``None`` and the `RoundTelemetry` (leading S·G, T)
    or ``None``, the same on every rank.  ``stream``: each trajectory's
    records after the run, scoped to rank 0's chunk."""
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
        scenario, topo_cfg, strategy, n_pad, group=group,
        draws_of=None if by_seed is None else by_seed.__getitem__,
        device=device, timers=timers, telemetry=telemetry)
    loss, acc, records, tele = sweep(_pad_to(seed_flat, n_pad),
                                     _pad_to(snr_flat, n_pad))
    loss, acc = loss[:n], acc[:n]
    if records is not None:
        records = {k: v[:n] for k, v in records.items()}
    if tele is not None:
        tele = nest_map(lambda x: x[:n], tele)
    if stream is not None:
        # Rank-0 emit: rank 0 runs the first n_pad / world trajectories.
        mine = min(n_pad // world, n)
        stream.scope_to_trajectories(zip(seed_flat[:mine], snr_flat[:mine]))
        emit_sweep(stream, seed_flat, snr_flat, loss, acc, tele,
                   rank=dist.get_rank(group))
    return loss, acc, records, tele


# ---------------------------------------------------------------------------
# Client-parallel execution of one trajectory (shard="clients").
# ---------------------------------------------------------------------------

#: The extras of the client-sharded round's telemetry (JAX's
#: ``_CLIENT_TELE_EXTRAS``): CWFL's hook's, from the sync's own internals.
CLIENT_TELE_EXTRAS = ("client_power", "noise_energy", "phase1_noise_std",
                      "phase2_noise_std", "power_budget_frac",
                      "precode_scale", "tx_power")


def _client_sharded_sync(stacked_local, state: cwfl.CWFLState, noise,
                         group=None, with_telemetry: bool = False):
    """One CWFL sync with the K clients split over ``group``; this rank
    holds ``stacked_local`` (leaves (K/n, ...)), the clients
    ``rank·K/n ... (rank+1)·K/n - 1``.

    ``noise``: ``(unit1, unit2)``, two (C, d) unit-normal matrices in the
    flat leaf order, the same on every rank.  Returns ``(new_local,
    consensus)``; the consensus is the same on every rank.
    ``with_telemetry`` adds a third element, the extras of
    `CLIENT_TELE_EXTRAS`, computed from the gathered powers and the
    round's coefficients (the same on every rank)."""
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
    mean_sq = torch.cat(gathered) / d
    A, eff_std1, B, kappa, m_back = cwfl.round_coefficients(
        state, mean_sq=mean_sq)
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
    new, cons = cwfl._flat_unpack(new_flat, cons_flat, leaves, treedef, kl)
    if not with_telemetry:
        return new, cons
    pre = cwfl.precode_scale(state, mean_sq)
    tx_power = ((1.0 - state.plan.head_mask)
                * ((state.client_power / state.total_power) * pre ** 2)
                * mean_sq)
    extras = {
        "precode_scale": pre,
        "client_power": state.client_power,
        "tx_power": tx_power,
        "power_budget_frac": torch.sum(tx_power) / state.total_power,
        "phase1_noise_std": eff_std1,
        "phase2_noise_std": kappa,
        "noise_energy": d * (torch.sum(eff_std1 ** 2)
                             + torch.sum(kappa ** 2)),
    }
    return new, cons, extras


def _client_sharded_telemetry(state: cwfl.CWFLState, tele_losses, new_local,
                              consensus, extras: dict, ledger: dict,
                              rows: slice, num_clients: int, uses: float,
                              group=None):
    """The client-sharded round's `RoundTelemetry` and ledger: the
    per-cluster losses summed over the ranks, each head's drift computed
    on the rank that holds its row and summed over the ranks (zeros
    elsewhere), the rest replicated."""
    plan = state.plan
    dev = tele_losses.device
    counts = torch.clamp(plan.membership.sum(dim=1), min=1.0)
    cluster = plan.membership[:, rows] @ tele_losses
    dist.all_reduce(cluster, op=dist.ReduceOp.SUM, group=group)
    kl = rows.stop - rows.start
    drift_rows = stacked_consensus_drift(new_local, consensus)   # (K/n,)
    own = (plan.heads >= rows.start) & (plan.heads < rows.stop)
    drift = torch.where(
        own, drift_rows[torch.clamp(plan.heads - rows.start, 0, kl - 1)],
        0.0)
    dist.all_reduce(drift, op=dist.ReduceOp.SUM, group=group)
    d = per_client_dim(new_local)
    used = torch.full((), float(uses), dtype=torch.float32, device=dev)
    new_ledger = {"uses": ledger["uses"] + used,
                  "symbols": ledger["symbols"] + used * d}
    tele = RoundTelemetry(
        cluster_loss=cluster / counts,
        participants=torch.full((), float(num_clients), dtype=torch.float32,
                                device=dev),
        consensus_drift=drift, channel_uses=used,
        cum_channel_uses=new_ledger["uses"],
        cum_symbols=new_ledger["symbols"],
        reclustered=torch.zeros((), dtype=torch.float32, device=dev),
        extras=extras)
    return tele, new_ledger


def run_rounds_client_sharded(init_fn: Callable, apply_fn: Callable,
                              loss_fn: Callable, topology: Topology,
                              xs: torch.Tensor, ys: torch.Tensor,
                              x_test: torch.Tensor, y_test: torch.Tensor,
                              cfg, scenario: Union[Scenario, str, None] = None,
                              group=None, progress: Optional[Callable] = None,
                              draws: Optional[Draws] = None, device=None, *,
                              mode: str = "scan", timers=None,
                              telemetry: bool = False,
                              checkpoint_dir=None, checkpoint_every: int = 0,
                              resume: bool = False,
                              resume_step: Optional[int] = None,
                              stop_after: Optional[int] = None,
                              stream=None) -> dict[str, Any]:
    """One trajectory with the K clients split over the ranks of ``group``
    (``None``: the default process group): per-rank local training on its
    K/n clients (rows of the full ``xs``/``ys`` every rank is given) and
    the collective CWFL sync, round after round.  Called by every rank;
    returns the same history on every rank, with the same keys as
    `repro_torch.sim.engine.run_rounds`.

    ``mode="scan"`` (default): an eager first round, then one CUDA graph a
    round, the collectives captured (eager on the CPU); ``mode="loop"``:
    an eager loop, which takes ``progress(r, loss, acc)`` (called on every
    rank).  Both give the same history.  ``timers``: as `run_rounds`'s.
    Static CWFL scenarios only, as JAX's client-sharded run.

    ``telemetry``, ``checkpoint_dir``/``checkpoint_every``/``resume``/
    ``resume_step``/``stop_after`` and ``stream``: as `run_rounds`'s, with
    JAX's argument checks.  The checkpoints hold the whole carry (rank 0
    writes them; every rank loads one and keeps its rows), the manifest's
    strategy ``<name>@clients``, so sharded and unsharded checkpoints are
    never spliced.  The stream takes rank 0's records; rank 0's monitor
    decides an abort for every rank."""
    check_obs_args(mode=mode, telemetry=telemetry, timers=timers,
                   checkpoint_dir=checkpoint_dir, resume=resume,
                   stop_after=stop_after, stream=stream)
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    scenario = scenario or Scenario()
    if not scenario.is_static:
        raise NotImplementedError(
            "shard='clients' takes static scenarios only, as the JAX "
            "package's client-sharded run does: its sync has no "
            "participation mask, fault fold or re-clustering")
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
    # The client split, from the dist rules (JAX's shard_map in-specs).
    mesh = {"clients": world}
    spec = client_specs(xs, mesh)
    if spec[0] is None:
        raise ValueError(f"K={K} clients must divide over the {world} ranks "
                         f"of the process group")
    kl = shard_size(spec, 0, K, mesh)
    rows = slice(rank * kl, (rank + 1) * kl)

    device = resolve_device(device)
    with _reference_numerics():
        topology = topology.to(device)
        xs_l, ys_l = xs[rows].to(device), ys[rows].to(device)
        x_ev = x_test[: cfg.eval_samples].to(device)
        y_ev = y_test[: cfg.eval_samples].to(device)
        draws = draws if draws is not None else TorchDraws(cfg.seed, device)
        state, consensus, optimizer, local_run, steps = _prepare(
            init_fn, loss_fn, topology, cfg, strategy, draws, n_k, device)
        stacked = tree_map(lambda x: x.expand((kl,) + x.shape).clone(),
                           consensus)
        carry0 = {"stacked": stacked, "opt": optimizer.init(stacked),
                  "consensus": consensus}
        if telemetry:
            carry0["obs"] = init_ledger(device)
        d = tree_size(consensus)
        uses = strategy.channel_uses(K, num_clusters=cfg.num_clusters)

        def round_draws(t: int) -> RoundDraws:
            # The global draws, of which this rank takes its clients' rows.
            rd = take_round(draws, t, strategy=strategy, scenario=scenario,
                            num_clients=K, steps=steps, batch=cfg.batch_size,
                            n_k=n_k, num_clusters=cfg.num_clusters, d=d)
            return _on(rd._replace(idx=rd.idx[rows]), device)

        def body(carry: dict, rd: RoundDraws, t: int):
            del t
            trained, opt_state, client_loss = local_run(
                carry["stacked"], carry["opt"], xs_l, ys_l, rd.idx)
            with torch.no_grad():
                new, cons, *extras = _client_sharded_sync(
                    trained, state, rd.noise, group,
                    with_telemetry=telemetry)
                acc = accuracy(apply_fn(cons, x_ev), y_ev)
                total = torch.sum(client_loss).reshape(1)
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
                new_carry = {"stacked": new, "opt": opt_state,
                             "consensus": cons}
                out = {"loss": total[0] / K, "acc": acc}
                if telemetry:
                    # A fresh full-shard forward on this rank's clients.
                    out["telemetry"], new_carry["obs"] = \
                        _client_sharded_telemetry(
                            state, loss_fn(trained, xs_l, ys_l), new, cons,
                            extras[0], carry["obs"], rows, K, uses, group)
            return new_carry, out

        if mode == "loop":
            outs, carry = [], carry0
            for t in range(cfg.rounds):
                with _phase(timers, "execute"):
                    carry, out = body(carry, round_draws(t), t)
                    if timers is not None and device.type == "cuda":
                        torch.cuda.synchronize(device)
                outs.append(out)
                if progress is not None:
                    progress(t + 1, float(out["loss"]), float(out["acc"]))
            return _history(outs, carry["consensus"])

        ckpt = None
        if checkpoint_dir is not None:
            ckpt = _sharded_checkpoints(
                checkpoint_dir, checkpoint_every, cfg, scenario, strategy,
                resume=resume, resume_step=resume_step,
                stop_after=stop_after, draws=draws, carry0=carry0, K=K,
                rows=rows, group=group, device=device)
        tap = (LiveTap(stream, seed=cfg.seed, snr_db=cfg.snr_db,
                       device=device, rank=rank)
               if stream is not None else None)
        carry, outs = scan_rounds(body, carry0, device, cfg.rounds,
                                  lambda t: (), round_draws, timers=timers,
                                  ckpt=ckpt, tap=tap)
        history = _history(outs, carry["consensus"])
        if ckpt is not None:
            history["checkpoint"] = ckpt.record()
        return history


def _sharded_checkpoints(directory, every: int, cfg, scenario, strategy, *,
                         resume: bool, resume_step: Optional[int],
                         stop_after: Optional[int], draws, carry0: dict,
                         K: int, rows: slice, group, device) -> _Checkpoints:
    """The client-sharded run's `_Checkpoints`: the whole carry on disk
    (this rank's rows of ``"stacked"`` gathered over the ranks), written by
    rank 0 alone, each rank keeping its rows of a loaded one; the manifest
    validated on every rank, then written by rank 0."""
    rank = dist.get_rank(group)
    name = strategy.name + "@clients"
    checkpoint_manifest(directory, cfg, scenario, name, resume, write=False)
    dist.barrier(group=group)
    if rank == 0:
        checkpoint_manifest(directory, cfg, scenario, name, resume)
    dist.barrier(group=group)

    def to_disk(carry: dict) -> dict:
        return dict(carry, stacked=tree_map(lambda x: _gather_rows(x, group),
                                            carry["stacked"]))

    def from_disk(carry: dict) -> dict:
        return dict(carry, stacked=tree_map(lambda x: x[rows],
                                            carry["stacked"]))

    def agree(stop: bool) -> bool:
        flag = torch.tensor([float(stop)], device=device)
        dist.broadcast(flag, src=dist.get_global_rank(group, 0)
                       if group is not None else 0, group=group)
        return bool(flag.item())

    return _Checkpoints(
        directory, every, cfg.rounds, resume=resume, resume_step=resume_step,
        stop_after=stop_after, draws=draws,
        template=dict(carry0, stacked=tree_map(
            lambda x: x.new_empty((K,) + x.shape[1:]), carry0["stacked"])),
        to_disk=to_disk, from_disk=from_disk, writer=rank == 0,
        barrier=lambda: dist.barrier(group=group), agree=agree)
