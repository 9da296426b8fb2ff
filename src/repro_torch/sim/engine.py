"""The FL round loop (port of `repro.sim.engine`).

The JAX engine scans rounds on device; here the rounds are a Python loop
(PyTorch runs eagerly).  One round:

    local:  E epochs of minibatch SGD per client   (batched over K)
    sync:   strategy aggregation — CWFL through the fused round kernel
    eval:   consensus accuracy on ``x_test[:eval_samples]``

A dynamic scenario (`repro_torch.sim.scenarios`) adds the JAX engine's
``dynamic_sync`` to the sync (`_Dynamics`): the channel process, the
participation schedule, the fault plane with its quarantine and
head-failure handoff, imperfect CSI, periodic re-clustering, the per-round
state rebuild, and the receive-side fold of a masked round.  The static
scenario runs the sync alone.

Per-round metrics stay on the device until the run ends, unless a
``progress`` callback asks for them each round.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.channel import snr_db_to_noise_var
from repro_torch.core.topology import Topology, TopologyConfig
from repro_torch.models.small import accuracy
from repro_torch.optim import sgd
from repro_torch.sim.draws import Draws, TorchDraws
from repro_torch.sim.faults import init_faults, quarantine_mask, step_faults
from repro_torch.sim.processes import (ChannelView, channel_view,
                                       csi_perturbation, init_channel,
                                       step_channel)
from repro_torch.sim.scenarios import Scenario, get_scenario
from repro_torch.sim.scheduling import init_schedule, participation_mask
from repro_torch.strategies import get_strategy
from repro_torch.training.local import make_local_runner
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_flatten, tree_map, tree_size,
                                      tree_unflatten)


@contextlib.contextmanager
def _full_f32():
    """TF32 off for the run, the caller's flags back after it: the JAX
    reference computes in full f32, and TF32 would keep ~3 digits."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _tree_where(mask: torch.Tensor, a, b):
    """Per-leaf ``where(mask > 0, a, b)``, ``mask`` indexing each leaf's
    leading axis (the K clients of a stacked tree, or one entry)."""
    a_leaves, treedef = tree_flatten(a)
    b_leaves, _ = tree_flatten(b)
    return tree_unflatten(treedef, [
        torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)) > 0, x, y)
        for x, y in zip(a_leaves, b_leaves)])


def _to_device(noise, device):
    """A strategy's sync noise (``None``, a tensor or a tuple of them) on
    ``device``."""
    if isinstance(noise, tuple):
        return tuple(x.to(device) for x in noise)
    return None if noise is None else noise.to(device)


def _prepare(init_fn: Callable, loss_fn: Callable, topology: Topology, cfg,
             strategy, draws: Draws, n_k: int, device):
    """A run's offline strategy state, initial consensus, optimizer and
    local runner, drawn in the same order by the unsharded loop and the
    client-sharded one (`repro_torch.sim.sharded`).  The FedProx µ_p
    resolves through the strategy (``cwfl_prox`` and ``cotaf_prox`` carry
    the paper's; ``cfg.mu_prox > 0`` overrides it)."""
    # E epochs of minibatch SGD over each client's n_k examples.
    steps = max(cfg.local_epochs * (n_k // cfg.batch_size), 1)
    optimizer = sgd(cfg.lr)
    local_run = make_local_runner(loss_fn, optimizer, cfg.batch_size, steps,
                                  strategy.effective_mu_prox(cfg.mu_prox))
    state = strategy.init(topology, draws, cfg, snr_db=cfg.snr_db)
    consensus = tree_map(lambda x: x.to(device), draws.init_params(init_fn))
    return state, consensus, optimizer, local_run, steps


def _history(losses: list, accs: list, consensus) -> dict[str, Any]:
    """The per-round metrics of a run, stacked on the device."""
    loss, acc = torch.stack(losses), torch.stack(accs)
    return {"round": np.arange(1, len(losses) + 1), "train_loss": loss,
            "test_acc": acc, "final_params": consensus,
            "avg_acc": torch.mean(acc), "final_acc": acc[-1]}


class _Dynamics:
    """A dynamic scenario's processes over one trajectory, and its sync
    (the JAX engine's ``dynamic_sync``).  Each round, in JAX's order: the
    channel step and its view; the schedule's mask; the fault step
    (``alive``, transmit outages folded into the mask, quarantine); the CSI
    error if the strategy water-fills; re-clustering every
    ``recluster_every`` rounds if it has a cluster plan; the head-failure
    handoff; the state rebuild; the aggregation; the receive-side fold,
    unless the strategy's ``receive_mask`` is ``None``.  ``records`` keeps,
    per round, the live nodes, the mask's mass, the quarantined clients
    and, for a strategy with a cluster plan, the heads, on the device."""

    def __init__(self, scenario: Scenario, strategy, topology: Topology,
                 topo_cfg: Optional[TopologyConfig], cfg, state0,
                 draws: Draws, device):
        self.scenario, self.strategy = scenario, strategy
        self.topology, self.topo_cfg = topology, topo_cfg
        self.num_clusters = cfg.num_clusters
        self.state0, self.draws, self.device = state0, draws, device
        self.K = K = topology.num_clients
        self.noise_var = (topology.noise_var if cfg.snr_db is None else
                          snr_db_to_noise_var(topology.total_power,
                                              cfg.snr_db))
        self.sched = (None if scenario.schedule.is_trivial else
                      init_schedule(scenario.schedule, K, device))
        self.faults = (None if scenario.faults.is_trivial else
                       init_faults(scenario.faults, K, device))
        self.chan = None
        if scenario.channel.evolves_geometry:
            self.chan = init_channel(topology, topo_cfg,
                                     draws.channel_init(K).to(device))
        self.plan = (state0.plan if strategy.reclusters
                     and scenario.recluster_every > 0 else None)
        self.records = {"alive": [], "mask_mass": [], "quarantined": []}
        if strategy.reclusters:
            self.records["heads"] = []

    def sync(self, t: int, trained, pre_round, consensus, noise):
        """One sync of round ``t`` on the locally ``trained`` params;
        ``pre_round`` and ``consensus`` are the round's starting params and
        the last consensus.  Returns ``(new_stacked, consensus)``."""
        sc, strategy = self.scenario, self.strategy
        K, dev = self.K, self.device
        if self.chan is not None:
            self.chan = step_channel(
                self.chan, sc.channel, self.topo_cfg,
                self._to_device(self.draws.channel_step(t, K)))
            view = channel_view(self.chan, self.topo_cfg)
        else:
            view = ChannelView(link_gain=self.topology.link_gain,
                               link_snr=self.topology.link_snr,
                               adjacency=self.topology.adjacency)

        mask = None
        if self.sched is not None:
            mask, self.sched = participation_mask(
                sc.schedule, self.sched, t,
                self.draws.schedule_uniforms(t, K).to(dev))

        alive = None
        quarantined = torch.zeros((), device=dev)
        if self.faults is not None:
            # Transmit outages fold into the mask; a quarantined client
            # transmits nothing and keeps its pre-round params (0 × NaN =
            # NaN, so masking alone cannot contain a non-finite update).
            self.faults, fview = step_faults(
                self.faults, sc.faults,
                self._to_device(self.draws.fault_uniforms(t, K)))
            alive = fview.alive
            mask = fview.tx_ok if mask is None else mask * fview.tx_ok
            if sc.faults.divergence_guard:
                q = quarantine_mask(trained, sc.faults.quarantine_norm)
                trained = _tree_where(q, trained, pre_round)
                mask = mask * q
                quarantined = K - q.sum()

        csi = None
        if strategy.water_fills and sc.channel.csi_error_std > 0:
            csi = csi_perturbation(self.draws.csi_normals(t, K).to(dev),
                                   sc.channel.csi_error_std)

        plan = None
        if self.plan is not None:
            if t % sc.recluster_every == 0:
                self.plan = strategy.recluster(
                    view, self.num_clusters,
                    self.draws.recluster_first(t, K))
            plan = self.plan
        if alive is not None:
            plan = strategy.on_head_failure(self.state0, plan, view, alive)

        state = strategy.state_from_view(self.state0, view, self.noise_var,
                                         csi=csi, mask=mask, plan=plan,
                                         alive=alive)
        new, new_consensus = strategy.aggregate(trained, state, noise,
                                                mask=mask, alive=alive)
        recv = (strategy.receive_mask(state, mask, alive=alive)
                if mask is not None else None)
        if recv is not None:
            # Absent clients keep their locally trained params, receivers
            # forced present keep the aggregate; if nobody took part the
            # sync is skipped and the last consensus stands (which also
            # discards FedAvg's 0/0 weights) — decided on the device.
            present = (torch.sum(mask) > 0).to(torch.float32)
            new = _tree_where(recv * present, new, trained)
            new_consensus = _tree_where(present[None], new_consensus,
                                        consensus)

        rec = self.records
        rec["alive"].append(torch.sum(alive) if alive is not None else
                            torch.tensor(float(K), device=dev))
        rec["mask_mass"].append(torch.sum(mask) if mask is not None else
                                torch.tensor(float(K), device=dev))
        rec["quarantined"].append(quarantined)
        if "heads" in rec:
            rec["heads"].append(state.plan.heads)
        return new, new_consensus

    def _to_device(self, draws):
        return type(draws)(*(x.to(self.device) for x in draws))


def run_rounds(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
               topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
               x_test: torch.Tensor, y_test: torch.Tensor, cfg,
               scenario: Union[Scenario, str, None] = None,
               topo_cfg: Optional[TopologyConfig] = None,
               progress: Optional[Callable] = None,
               draws: Optional[Draws] = None,
               device=None, shard: Optional[str] = None,
               group=None) -> dict[str, Any]:
    """Run one FL trajectory; returns a history of per-round metrics.

    ``xs, ys``: stacked client shards (K, N_k, ...).  ``loss_fn(params, x,
    y)`` must take K-stacked params and (K, B, ...) batches.
    ``scenario``: a `Scenario`, a registered name, or ``None`` (the
    static ``paper-static``).  ``topo_cfg``: the `TopologyConfig` that made
    ``topology``; a scenario whose channel evolves needs it.
    ``progress(r, loss, acc)``: optional per-round callback (syncs the host
    every round).  ``draws``: the run's random draws (default: `TorchDraws`
    seeded from ``cfg.seed`` on ``device``).  ``device``: where the run
    happens (``None`` = the GPU); inputs are moved there.
    ``shard="clients"``: split the K clients over the ranks of the
    ``torch.distributed`` process group ``group`` (``None``: the default
    group), one process a rank (`repro_torch.sim.sharded.
    run_rounds_client_sharded`); static CWFL scenarios only.

    The history holds per-round ``train_loss`` and ``test_acc`` (T,) and the
    final consensus; a dynamic scenario adds ``scenario``: per round, the
    live nodes, the mask's mass, the quarantined clients (T,) and, for a
    strategy with a cluster plan, the heads (T, C).
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    scenario = scenario or Scenario()
    strategy = get_strategy(cfg.strategy)
    if scenario.strategy is not None and scenario.strategy != strategy.name:
        warnings.warn(
            f"scenario {scenario.name!r} pins strategy "
            f"{scenario.strategy!r} but the run uses cfg.strategy="
            f"{strategy.name!r}; pass FLConfig(strategy="
            f"{scenario.strategy!r}) to honor the scenario's pin",
            UserWarning, stacklevel=2)
    if shard is not None:
        if shard != "clients":
            raise ValueError(
                f"run_rounds shards the client axis only (shard='clients'); "
                f"got {shard!r} — trajectory sharding (shard='mc') waits "
                f"for run_monte_carlo")
        from repro_torch.sim import sharded
        return sharded.run_rounds_client_sharded(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, scenario=scenario, group=group, progress=progress,
            draws=draws, device=device)
    if scenario.channel.evolves_geometry and topo_cfg is None:
        raise ValueError(
            "dynamic-channel scenarios need the TopologyConfig that "
            "generated the topology (geometry statics: area, d0, ς, "
            "outage threshold)")
    device = resolve_device(device)
    with _full_f32():
        topology = topology.to(device)
        xs, ys = xs.to(device), ys.to(device)
        x_ev = x_test[: cfg.eval_samples].to(device)
        y_ev = y_test[: cfg.eval_samples].to(device)
        draws = draws if draws is not None else TorchDraws(cfg.seed, device)
        K, n_k = xs.shape[0], xs.shape[1]
        state, consensus, optimizer, local_run, steps = _prepare(
            init_fn, loss_fn, topology, cfg, strategy, draws, n_k, device)
        stacked = tree_map(lambda x: x.expand((K,) + x.shape).clone(),
                           consensus)
        opt_state = optimizer.init(stacked)
        d = tree_size(consensus)
        dynamics = (None if scenario.is_static else _Dynamics(
            scenario, strategy, topology, topo_cfg, cfg, state, draws,
            device))

        losses, accs = [], []
        for t in range(cfg.rounds):
            idx = draws.batch_indices(t, K, steps, cfg.batch_size, n_k)
            trained, opt_state, client_loss = local_run(
                stacked, opt_state, xs, ys, idx.to(device))
            noise = _to_device(strategy.sync_noise(
                draws, t, K, cfg.num_clusters, d), device)
            with torch.no_grad():
                if dynamics is None:
                    stacked, consensus = strategy.aggregate(trained, state,
                                                            noise)
                else:
                    stacked, consensus = dynamics.sync(t, trained, stacked,
                                                       consensus, noise)
                acc = accuracy(apply_fn(consensus, x_ev), y_ev)
            loss = torch.mean(client_loss)
            losses.append(loss)
            accs.append(acc)
            if progress is not None:
                progress(t + 1, float(loss), float(acc))

        history = _history(losses, accs, consensus)
        if dynamics is not None:
            history["scenario"] = {k: torch.stack(v) for k, v in
                                   dynamics.records.items()}
        return history
