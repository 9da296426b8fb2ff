"""The FL round engine (port of `repro.sim.engine`).

One round:

    local:  E epochs of minibatch SGD per client   (batched over K)
    sync:   strategy aggregation — CWFL through the fused round kernel
    eval:   consensus accuracy on ``x_test[:eval_samples]``

A dynamic scenario (`repro_torch.sim.scenarios`) adds the JAX engine's
``dynamic_sync`` to the sync (`_Dynamics`): the channel process, the
participation schedule, the fault plane with its quarantine and
head-failure handoff, imperfect CSI, periodic re-clustering, the per-round
state rebuild, and the receive-side fold of a masked round.  The static
scenario runs the sync alone.

The round is one function of its carry (the clients' params, the
optimizer state, the consensus and a scenario's process states) and its
draws, taken before it (`repro_torch.sim.draws.take_round`): the
counterpart of the JAX engine's scan body and its per-round ``scan_xs``.
Two executors run it (``run_rounds(mode=)``):

* ``"loop"``: a Python loop over rounds, eagerly, with an optional live
  ``progress`` callback;
* ``"scan"`` (the default, as JAX's): the counterpart of compiling the
  trajectory into one jit (`_Replayer`).  On a CUDA device the first round
  runs eagerly (the warm-up, a real round), then the round is captured
  once into a CUDA graph and replayed for the rest, the carry in fixed
  buffers that each replay updates in place, each round's draws copied
  into the graph's input buffers before it, its metrics copied out after
  it.  A round whose Python-level branches differ (a re-clustering round
  of ``cluster-churn``, a straggler round) gets a graph of its own.  On
  the CPU the same body runs eagerly on the same buffers.

`run_monte_carlo` runs a sweep of trajectories (seeds × SNRs, JAX's
``vmap`` grid) as one batch: their clients stacked beside K, their
states stacked along a leading trajectory axis, one launch of each
kernel a round for all of them (`_Sweep`), through the same executor.

Per-round metrics stay on the device until the run ends, unless a
``progress`` callback asks for them each round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.channel import snr_db_to_noise_var
from repro_torch.core.topology import Topology, TopologyConfig
from repro_torch.models.small import accuracy
from repro_torch.optim import sgd
from repro_torch.sim.draws import Draws, RoundDraws, TorchDraws, take_round
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


# ---------------------------------------------------------------------------
# Carries and draws as flat lists of tensors (the executor's buffers).
# ---------------------------------------------------------------------------

def _tensors(obj) -> list:
    """The tensors of a nest of dicts (in key order), tuples, named
    tuples, lists and dataclasses; anything else is a constant of the
    nest."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _tensors(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in _tensors(getattr(obj, f.name))]
    return []


def _rebuild(obj, tensors):
    """``obj`` with its tensors (:func:`_tensors`' order) taken from the
    iterator ``tensors``."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if isinstance(obj, dict):
        out = {k: _rebuild(obj[k], tensors) for k in sorted(obj)}
        return {k: out[k] for k in obj}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(v, tensors) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, tensors) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj)})
    return obj


def _phase(timers, name: str):
    """``timers.phase(name)``, or nothing without timers."""
    return (timers.phase(name) if timers is not None
            else contextlib.nullcontext())


@contextlib.contextmanager
def _host_syncs_raise():
    """A host sync raises (``torch.cuda.set_sync_debug_mode("error")``):
    the warm-up round finds, at its source, every sync that would break
    the capture after it."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _on(obj, device):
    """A nest (:func:`_tensors`) with its tensors on ``device``."""
    return _rebuild(obj, iter([x.to(device) for x in _tensors(obj)]))


class _Replayer:
    """Runs a round body ``body(carry, draws, t) -> (carry, out)`` on fixed
    buffers: the carry lives in buffers that each round reads and then
    overwrites in place, and ``out`` (the round's metrics, a dict of
    tensors) is copied out after the round.

    On a CUDA device the first round runs eagerly on a side stream (the
    warm-up: a real round, consuming its own draws and nothing more, in
    which a host sync raises), and each later round replays a CUDA graph
    of the body, captured once for each ``key`` (the round's Python-level
    branches; the body may read ``t`` only through them), on that stream
    and in its own memory pool;
    the round's draws are copied into the graph's input buffers before the
    replay.  Nothing falls back: a body that cannot be captured raises.
    On the CPU every round runs eagerly on the same buffers.

    ``timers`` (`repro_torch.obs.PhaseTimers`): the warm-up and each
    capture under ``trace_compile``, the rounds after them (their draws
    included) under ``execute``; before a capture after the first, the
    device finishes the rounds so far under ``execute``, so no round's
    device time lands in a capture's."""

    def __init__(self, body: Callable, carry0, device: torch.device,
                 timers=None):
        self.body, self.device, self.timers = body, device, timers
        self.carry = carry0
        self.bufs = [x.clone() for x in _tensors(carry0)]
        self.graphs: dict = {}
        self.capture = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.capture else None
        self.rounds = 0

    def _phase(self, name: str):
        return _phase(self.timers, name)

    def state(self):
        """The carry as the buffers hold it now."""
        return _rebuild(self.carry, iter(self.bufs))

    def _step(self, draws, t: int) -> dict:
        """One round on the buffers: the body, then its new carry written
        back into them.  A result that shares memory with a buffer other
        than its own is copied first, so no write-back reads a buffer
        another has overwritten."""
        new, out = self.body(self.state(), draws, t)
        owned = {b.untyped_storage().data_ptr() for b in self.bufs}

        def detached(x, own=None):
            if x is not own and x.untyped_storage().data_ptr() in owned:
                return x.clone()
            return x

        new_tensors = _tensors(new)
        if len(new_tensors) != len(self.bufs):
            raise RuntimeError(f"the round's carry has {len(new_tensors)} "
                               f"tensors, its buffers {len(self.bufs)}")
        new_tensors = [detached(x, b) for x, b in zip(new_tensors, self.bufs)]
        out = {k: detached(v) for k, v in out.items()}
        for b, x in zip(self.bufs, new_tensors):
            if x.shape != b.shape or x.dtype != b.dtype:
                raise RuntimeError(f"the round changed a carry tensor from "
                                   f"{tuple(b.shape)} {b.dtype} to "
                                   f"{tuple(x.shape)} {x.dtype}")
            if x is not b:
                b.copy_(x)
        return out

    def run(self, t: int, key, take_draws: Callable) -> dict:
        """Round ``t``: its ``key``, and ``take_draws()`` its draws (a nest
        of tensors, taken inside the round's phase); returns its metrics,
        copied out of the round."""
        first = self.rounds == 0
        self.rounds += 1
        if not self.capture:
            with self._phase("trace_compile" if first else "execute"):
                return {k: v.clone() for k, v in self._step(
                    _on(take_draws(), self.device), t).items()}
        if first:
            with self._phase("trace_compile"):
                draws = _on(take_draws(), self.device)
                current = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream), _host_syncs_raise():
                    out = {k: v.clone() for k, v in
                           self._step(draws, t).items()}
                current.wait_stream(self.stream)
                torch.cuda.synchronize(self.device)
            return out
        with self._phase("execute"):
            draws = take_draws()
        if key not in self.graphs:
            with self._phase("execute"):
                torch.cuda.synchronize(self.device)
            with self._phase("trace_compile"):
                inputs = [torch.empty_like(x, device=self.device)
                          for x in _tensors(draws)]
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=self.stream):
                    out = self._step(_rebuild(draws, iter(inputs)), t)
                self.graphs[key] = (graph, inputs, out)
        with self._phase("execute"):
            graph, inputs, out = self.graphs[key]
            for buf, x in zip(inputs, _tensors(draws)):
                buf.copy_(x)
            graph.replay()
            return {k: v.clone() for k, v in out.items()}

    def finish(self) -> None:
        """The end of the run: wait for the device (under ``execute``)."""
        if self.capture:
            with self._phase("execute"):
                torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# One trajectory.
# ---------------------------------------------------------------------------

def _prepare(init_fn: Callable, loss_fn: Callable, topology: Topology, cfg,
             strategy, draws: Draws, n_k: int, device):
    """A run's offline strategy state, initial consensus, optimizer and
    local runner, drawn in the same order by the unsharded run and the
    client-sharded one (`repro_torch.sim.sharded`).  The FedProx µ_p
    resolves through the strategy (``cwfl_prox`` and ``cotaf_prox`` carry
    the paper's; ``cfg.mu_prox > 0`` overrides it)."""
    steps, optimizer, local_run = _local(loss_fn, cfg, strategy, n_k)
    state = strategy.init(topology, draws, cfg, snr_db=cfg.snr_db)
    consensus = tree_map(lambda x: x.to(device), draws.init_params(init_fn))
    return state, consensus, optimizer, local_run, steps


def _local(loss_fn: Callable, cfg, strategy, n_k: int):
    """``(steps, optimizer, local_run)``: E epochs of minibatch SGD over
    each client's n_k examples (a constant learning rate, so the
    optimizer's state holds no tensor a captured round would have to
    carry)."""
    steps = max(cfg.local_epochs * (n_k // cfg.batch_size), 1)
    optimizer = sgd(cfg.lr)
    local_run = make_local_runner(loss_fn, optimizer, cfg.batch_size, steps,
                                  strategy.effective_mu_prox(cfg.mu_prox))
    return steps, optimizer, local_run


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
    unless the strategy's ``receive_mask`` is ``None``.  The processes'
    states ride in the round's carry (:meth:`carry0`); each round records
    the live nodes, the mask's mass, the quarantined clients and, for a
    strategy with a cluster plan, the heads."""

    def __init__(self, scenario: Scenario, strategy, topology: Topology,
                 topo_cfg: Optional[TopologyConfig], cfg, state0,
                 draws: Draws, device):
        self.scenario, self.strategy = scenario, strategy
        self.topology, self.topo_cfg = topology, topo_cfg
        self.num_clusters = cfg.num_clusters
        self.state0, self.device = state0, device
        self.K = K = topology.num_clients
        self.noise_var = (topology.noise_var if cfg.snr_db is None else
                          snr_db_to_noise_var(topology.total_power,
                                              cfg.snr_db))
        self._carry0 = {}
        if not scenario.schedule.is_trivial:
            self._carry0["sched"] = init_schedule(scenario.schedule, K,
                                                  device)
        if not scenario.faults.is_trivial:
            self._carry0["faults"] = init_faults(scenario.faults, K, device)
        if scenario.channel.evolves_geometry:
            self._carry0["chan"] = init_channel(
                topology, topo_cfg, draws.channel_init(K).to(device))
        self.reclusters = (strategy.reclusters
                           and scenario.recluster_every > 0)
        if self.reclusters:
            self._carry0["plan"] = state0.plan

    def carry0(self) -> dict:
        """The processes' states before round 0."""
        return dict(self._carry0)

    def recluster_round(self, t: int) -> bool:
        return self.reclusters and t % self.scenario.recluster_every == 0

    def key(self, t: int) -> tuple:
        """Round ``t``'s Python-level branches: a re-clustering round, a
        straggler round (all the sync reads of ``t``)."""
        sch = self.scenario.schedule
        straggle = (sch.num_stragglers > 0 and sch.straggler_period > 0
                    and t % sch.straggler_period == sch.straggler_period - 1)
        return (self.recluster_round(t), straggle)

    def sync(self, t: int, carry: dict, trained, rd: RoundDraws):
        """One sync of round ``t`` on the locally ``trained`` params;
        ``carry`` holds the round's starting params, the last consensus
        and the processes' states.  Returns ``(new_stacked, consensus,
        updates, record)``: ``updates`` the processes' new states."""
        sc, strategy = self.scenario, self.strategy
        K, dev = self.K, self.device
        pre_round, consensus = carry["stacked"], carry["consensus"]
        updates = {}
        if "chan" in carry:
            updates["chan"] = step_channel(carry["chan"], sc.channel,
                                           self.topo_cfg, rd.channel)
            view = channel_view(updates["chan"], self.topo_cfg)
        else:
            view = ChannelView(link_gain=self.topology.link_gain,
                               link_snr=self.topology.link_snr,
                               adjacency=self.topology.adjacency)

        mask = None
        if "sched" in carry:
            mask, updates["sched"] = participation_mask(
                sc.schedule, carry["sched"], t, rd.schedule)

        alive = None
        quarantined = torch.zeros((), device=dev)
        if "faults" in carry:
            # Transmit outages fold into the mask; a quarantined client
            # transmits nothing and keeps its pre-round params (0 × NaN =
            # NaN, so masking alone cannot contain a non-finite update).
            updates["faults"], fview = step_faults(carry["faults"],
                                                   sc.faults, rd.faults)
            alive = fview.alive
            mask = fview.tx_ok if mask is None else mask * fview.tx_ok
            if sc.faults.divergence_guard:
                q = quarantine_mask(trained, sc.faults.quarantine_norm)
                trained = _tree_where(q, trained, pre_round)
                mask = mask * q
                quarantined = K - q.sum()

        csi = (csi_perturbation(rd.csi, sc.channel.csi_error_std)
               if rd.csi is not None else None)

        plan = None
        if self.reclusters:
            if self.recluster_round(t):
                updates["plan"] = strategy.recluster(view, self.num_clusters,
                                                     rd.recluster)
            plan = updates.get("plan", carry["plan"])
        if alive is not None:
            plan = strategy.on_head_failure(self.state0, plan, view, alive)

        state = strategy.state_from_view(self.state0, view, self.noise_var,
                                         csi=csi, mask=mask, plan=plan,
                                         alive=alive)
        new, new_consensus = strategy.aggregate(trained, state, rd.noise,
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

        everyone = torch.full((), float(K), device=dev)
        record = {"alive": torch.sum(alive) if alive is not None
                  else everyone,
                  "mask_mass": torch.sum(mask) if mask is not None
                  else everyone.clone(),
                  "quarantined": quarantined}
        if strategy.reclusters:
            record["heads"] = state.plan.heads
        return new, new_consensus, updates, record


class _Trajectory:
    """One trajectory, prepared: its offline state, initial carry, the
    draws of each round and the round body, on ``device``."""

    def __init__(self, init_fn, apply_fn, loss_fn, topology, xs, ys, x_ev,
                 y_ev, cfg, scenario: Scenario, topo_cfg, strategy,
                 draws: Draws, device):
        self.apply_fn, self.cfg, self.strategy = apply_fn, cfg, strategy
        self.scenario, self.draws, self.device = scenario, draws, device
        self.xs, self.ys, self.x_ev, self.y_ev = xs, ys, x_ev, y_ev
        self.K, self.n_k = K, n_k = xs.shape[0], xs.shape[1]
        self.state, consensus, optimizer, self.local_run, self.steps = \
            _prepare(init_fn, loss_fn, topology, cfg, strategy, draws, n_k,
                     device)
        stacked = tree_map(lambda x: x.expand((K,) + x.shape).clone(),
                           consensus)
        self.d = tree_size(consensus)
        self.carry0 = {"stacked": stacked, "opt": optimizer.init(stacked),
                       "consensus": consensus}
        self.dynamics = (None if scenario.is_static else _Dynamics(
            scenario, strategy, topology, topo_cfg, cfg, self.state, draws,
            device))
        if self.dynamics is not None:
            self.carry0.update(self.dynamics.carry0())

    def key(self, t: int) -> tuple:
        return () if self.dynamics is None else self.dynamics.key(t)

    def round_draws(self, t: int) -> RoundDraws:
        """Round ``t``'s draws, in the loop's order
        (`repro_torch.sim.draws.take_round`), on the run's device."""
        cfg = self.cfg
        rd = take_round(
            self.draws, t, strategy=self.strategy, scenario=self.scenario,
            num_clients=self.K, steps=self.steps, batch=cfg.batch_size,
            n_k=self.n_k, num_clusters=cfg.num_clusters, d=self.d,
            recluster=(self.dynamics is not None
                       and self.dynamics.recluster_round(t)))
        return _on(rd, self.device)

    def body(self, carry: dict, rd: RoundDraws, t: int):
        """One round: local training, the sync, the eval.  Returns the new
        carry and the round's metrics."""
        trained, opt_state, client_loss = self.local_run(
            carry["stacked"], carry["opt"], self.xs, self.ys, rd.idx)
        new_carry = dict(carry, opt=opt_state)
        with torch.no_grad():
            if self.dynamics is None:
                stacked, consensus = self.strategy.aggregate(
                    trained, self.state, rd.noise)
                record = {}
            else:
                stacked, consensus, updates, record = self.dynamics.sync(
                    t, carry, trained, rd)
                new_carry.update(updates)
            acc = accuracy(self.apply_fn(consensus, self.x_ev), self.y_ev)
        new_carry.update(stacked=stacked, consensus=consensus)
        return new_carry, {"loss": torch.mean(client_loss), "acc": acc,
                           **record}


def _records(outs: list, static: bool) -> Optional[dict]:
    """A dynamic run's per-round records, stacked."""
    if static:
        return None
    keys = [k for k in outs[0] if k not in ("loss", "acc")]
    return {k: torch.stack([o[k] for o in outs]) for k in keys}


def run_rounds(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
               topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
               x_test: torch.Tensor, y_test: torch.Tensor, cfg,
               scenario: Union[Scenario, str, None] = None,
               topo_cfg: Optional[TopologyConfig] = None,
               mode: str = "scan",
               progress: Optional[Callable] = None,
               draws: Optional[Draws] = None,
               device=None, shard: Optional[str] = None,
               group=None, timers=None) -> dict[str, Any]:
    """Run one FL trajectory; returns a history of per-round metrics.

    ``xs, ys``: stacked client shards (K, N_k, ...).  ``loss_fn(params, x,
    y)`` must take K-stacked params and (K, B, ...) batches.
    ``scenario``: a `Scenario`, a registered name, or ``None`` (the
    static ``paper-static``).  ``topo_cfg``: the `TopologyConfig` that made
    ``topology``; a scenario whose channel evolves needs it.
    ``mode="scan"`` (default): the round captured into a CUDA graph after
    an eager first round and replayed (eager on the CPU), no host sync
    between rounds; ``mode="loop"``: an eager Python loop, which takes a
    live ``progress(r, loss, acc)`` callback (a host sync every round).
    Both give the same history.  ``draws``: the run's random draws
    (default: `TorchDraws` seeded from ``cfg.seed`` on ``device``).
    ``device``: where the run happens (``None`` = the GPU); inputs are
    moved there.  ``timers``: an optional
    `repro_torch.obs.PhaseTimers`, split into ``trace_compile`` (the
    warm-up round and the captures) and ``execute`` (the rest, to
    ``torch.cuda.synchronize``); in loop mode every round is ``execute``.
    ``shard="clients"``: split the K clients over the ranks of the
    ``torch.distributed`` process group ``group`` (``None``: the default
    group), one process a rank (`repro_torch.sim.sharded.
    run_rounds_client_sharded`); static CWFL scenarios, ``mode="loop"``.

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
    if mode not in ("scan", "loop"):
        raise ValueError(f"mode must be 'scan' or 'loop', got {mode!r}")
    if mode == "scan" and progress is not None:
        raise ValueError(
            "progress= reports each round as it ends, which the scanned "
            "trajectory does not stop for; pass mode='loop'")
    if shard is not None:
        if shard != "clients":
            raise ValueError(
                f"run_rounds shards the client axis only (shard='clients'); "
                f"got {shard!r} — trajectory sharding (shard='mc') lives in "
                f"run_monte_carlo")
        if mode != "loop":
            raise NotImplementedError(
                "shard='clients' runs its rounds in a loop (mode='loop'): "
                "capturing the client-sharded round over NCCL is not "
                "ported yet (ROADMAP §1 item 3, what is left)")
        if timers is not None:
            raise NotImplementedError(
                "timers= on the client-sharded run is not ported yet "
                "(ROADMAP §1 item 5: observability)")
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
        traj = _Trajectory(
            init_fn, apply_fn, loss_fn, topology.to(device), xs.to(device),
            ys.to(device), x_test[: cfg.eval_samples].to(device),
            y_test[: cfg.eval_samples].to(device), cfg, scenario, topo_cfg,
            strategy, draws if draws is not None else TorchDraws(cfg.seed,
                                                                 device),
            device)
        outs = []
        if mode == "loop":
            carry = traj.carry0
            for t in range(cfg.rounds):
                with _phase(timers, "execute"):
                    carry, out = traj.body(carry, traj.round_draws(t), t)
                    if timers is not None and device.type == "cuda":
                        torch.cuda.synchronize(device)
                outs.append(out)
                if progress is not None:
                    progress(t + 1, float(out["loss"]), float(out["acc"]))
            consensus = carry["consensus"]
        else:
            rep = _Replayer(traj.body, traj.carry0, device, timers)
            for t in range(cfg.rounds):
                outs.append(rep.run(t, traj.key(t),
                                    lambda t=t: traj.round_draws(t)))
            rep.finish()
            consensus = rep.state()["consensus"]

        history = _history([o["loss"] for o in outs],
                           [o["acc"] for o in outs], consensus)
        records = _records(outs, scenario.is_static)
        if records is not None:
            history["scenario"] = records
        return history


# ---------------------------------------------------------------------------
# A sweep of trajectories, batched.
# ---------------------------------------------------------------------------

def _gather(x, owner: torch.Tensor):
    """Each trajectory's rows of per-seed draws (``None``, a tensor or a
    tuple of them, leading axis the seeds): ``x[owner]``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_gather(v, owner) for v in x)
    return x[owner]


class _Sweep:
    """B trajectories of a static scenario run together: trajectory b is
    seed ``seeds[owner[b]]`` (its draws ``draws[owner[b]]``) at SNR
    ``snrs[b]``.  Their clients are stacked beside K (B·K rows, b-major,
    each reading its shard through the local runner's client → shard
    map), their states along a leading axis (`Strategy.init_batch`), and
    every round runs one set of launches for all of them: local training,
    the batched sync (`Strategy.aggregate_batch`), the batched eval.  A
    seed's trajectories share its draws, as JAX's inner ``vmap`` over the
    SNR axis shares its keys."""

    def __init__(self, init_fn, apply_fn, loss_fn, topology, xs, ys, x_ev,
                 y_ev, cfg, strategy, draws: Sequence[Draws],
                 owner: Sequence[int], snrs: Sequence, device):
        self.apply_fn, self.cfg, self.strategy = apply_fn, cfg, strategy
        self.draws, self.device = list(draws), device
        self.xs, self.ys, self.x_ev, self.y_ev = xs, ys, x_ev, y_ev
        self.K, self.n_k = K, n_k = xs.shape[0], xs.shape[1]
        self.B = B = len(owner)
        self.owner = torch.as_tensor(list(owner), dtype=torch.int64,
                                     device=device)
        self.steps, optimizer, self.local_run = _local(loss_fn, cfg,
                                                       strategy, n_k)
        self.state = _on(strategy.init_batch(
            topology, self.draws, cfg, list(zip(owner, snrs))), device)
        # Each seed's initial params, then trajectory b's are its seed's.
        per_seed = [tree_flatten(dr.init_params(init_fn))
                    for dr in self.draws]
        treedef = per_seed[0][1]
        consensus = tree_unflatten(treedef, [
            torch.stack([per_seed[i][0][j] for i in owner]).to(device)
            for j in range(len(per_seed[0][0]))])
        stacked = tree_map(
            lambda x: x[:, None].expand((B, K) + x.shape[1:])
            .reshape((B * K,) + x.shape[1:]).clone(), consensus)
        self.d = sum(x.numel() for x in per_seed[0][0])
        # Stacked client b·K + k trains on shard k.
        self.rows = torch.arange(K, device=device).repeat(B)
        self.carry0 = {"stacked": stacked, "opt": optimizer.init(stacked),
                       "consensus": consensus}

    def round_draws(self, t: int) -> RoundDraws:
        """Round ``t``'s draws of every seed, stacked along a leading seed
        axis, on the run's device."""
        cfg = self.cfg
        idx = torch.stack([dr.batch_indices(t, self.K, self.steps,
                                            cfg.batch_size, self.n_k)
                           for dr in self.draws])
        noise = self.strategy.sync_noise_batch(self.draws, t, self.K,
                                               cfg.num_clusters, self.d)
        return _on(RoundDraws(idx=idx, noise=noise), self.device)

    def body(self, carry: dict, rd: RoundDraws, t: int):
        """One round of the B trajectories."""
        del t
        B, K = self.B, self.K
        idx = _gather(rd.idx, self.owner).reshape((B * K,)
                                                  + rd.idx.shape[2:])
        trained, opt_state, client_loss = self.local_run(
            carry["stacked"], carry["opt"], self.xs, self.ys, idx, self.rows)
        with torch.no_grad():
            stacked, consensus = self.strategy.aggregate_batch(
                trained, self.state, _gather(rd.noise, self.owner))
            x_ev = self.x_ev.expand((B,) + self.x_ev.shape)
            acc = accuracy(self.apply_fn(consensus, x_ev), self.y_ev)
        return ({"stacked": stacked, "opt": opt_state,
                 "consensus": consensus},
                {"loss": torch.mean(client_loss.reshape(B, K), dim=1),
                 "acc": acc})

    def run(self, rounds: int, timers=None):
        """The sweep's ``(loss, acc)``, each (B, rounds)."""
        rep = _Replayer(self.body, self.carry0, self.device, timers)
        outs = [rep.run(t, (), lambda t=t: self.round_draws(t))
                for t in range(rounds)]
        rep.finish()
        return (torch.stack([o["loss"] for o in outs], dim=1),
                torch.stack([o["acc"] for o in outs], dim=1))


def _sweep_grid(cfg, scenario: Scenario, seeds: int, snr_grid):
    """The sweep's seeds (``cfg.seed + arange(seeds)``, JAX's
    ``seed_arr``) and SNR grid (``snr_grid``, else the scenario's, else
    none: every trajectory at ``cfg.snr_db``)."""
    if snr_grid is None and scenario.snr_grid:
        snr_grid = scenario.snr_grid
    grid = (None if snr_grid is None or len(snr_grid) == 0
            else [float(g) for g in snr_grid])
    return [cfg.seed + i for i in range(seeds)], grid


def run_monte_carlo(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
                    topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
                    x_test: torch.Tensor, y_test: torch.Tensor, cfg,
                    scenario: Union[Scenario, str, None] = None,
                    topo_cfg: Optional[TopologyConfig] = None,
                    seeds: int = 8, snr_grid=None,
                    shard: Optional[str] = None, group=None,
                    timers=None, draws: Optional[Sequence[Draws]] = None,
                    device=None) -> dict[str, Any]:
    """Monte-Carlo grid: ``seeds`` × ``snr_grid`` full trajectories, run as
    one batch (JAX vmaps them into one jit): their clients stacked beside
    K, one set of launches a round for all of them, the round captured as
    in `run_rounds`'s scan mode.

    ``snr_grid`` defaults to ``scenario.snr_grid`` when the scenario
    defines one (e.g. ``snr-sweep``); ``None``/empty sweeps only seeds, at
    ``cfg.snr_db``.  The seeds are ``cfg.seed + arange(seeds)``; a seed's
    SNR points share its draws.  ``draws``: one `Draws` for each seed
    (default: `TorchDraws` of each seed on ``device``).  ``shard="mc"``
    splits the flattened seeds × SNR grid over the ranks of the
    ``torch.distributed`` group ``group`` (`repro_torch.sim.sharded.
    monte_carlo_sharded`), each rank running its chunk as one batch.
    ``timers``: as `run_rounds`'s.  Static scenarios only.

    Returns ``train_loss``/``test_acc`` of shape (S, T) or (S, G, T) on
    the device, ``final_acc`` (S[, G]), ``seeds`` (S,) and ``snr_grid``
    ((G,) f32, or ``None``).
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    scenario = scenario or Scenario()
    if not scenario.is_static:
        raise NotImplementedError(
            f"run_monte_carlo batches static scenarios; {scenario.name!r} "
            f"is dynamic (ROADMAP §1 item 4, what is left: dynamic "
            f"scenarios in the sweep, with kernel 2 batched)")
    strategy = get_strategy(cfg.strategy)
    seed_list, grid = _sweep_grid(cfg, scenario, seeds, snr_grid)
    if draws is not None and len(draws) != seeds:
        raise ValueError(f"draws= needs one Draws for each of the {seeds} "
                         f"seeds, got {len(draws)}")
    if shard is not None:
        if shard != "mc":
            raise ValueError(
                f"run_monte_carlo shards the trajectory grid only "
                f"(shard='mc'); got {shard!r} — client-axis sharding "
                f"(shard='clients') lives in run_rounds")
        from repro_torch.sim import sharded
        loss, acc = sharded.monte_carlo_sharded(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, strategy, seed_list, grid, group=group, timers=timers,
            draws=draws, device=device)
    else:
        device = resolve_device(device)
        G = 1 if grid is None else len(grid)
        owner = [i for i in range(seeds) for _ in range(G)]
        snrs = [cfg.snr_db] * seeds if grid is None else grid * seeds
        loss, acc = _run_sweep(init_fn, apply_fn, loss_fn, topology, xs, ys,
                               x_test, y_test, cfg, strategy, seed_list,
                               owner, snrs, draws, device, timers)
    shape = (seeds,) if grid is None else (seeds, len(grid))
    loss = loss.reshape(shape + (cfg.rounds,))
    acc = acc.reshape(shape + (cfg.rounds,))
    return {"train_loss": loss, "test_acc": acc, "final_acc": acc[..., -1],
            "seeds": torch.tensor(seed_list),
            "snr_grid": (None if grid is None
                         else torch.tensor(grid, dtype=torch.float32))}


def _run_sweep(init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
               cfg, strategy, seed_list: Sequence[int], owner: Sequence[int],
               snrs: Sequence, draws: Optional[Sequence[Draws]], device,
               timers=None):
    """The trajectories ``(seed_list[owner[b]], snrs[b])`` as one batch on
    ``device``; ``draws`` (one for each of ``seed_list``, or ``None``:
    `TorchDraws` of each seed).  Returns ``(loss, acc)``, each
    (B, rounds)."""
    with _full_f32():
        draws = (list(draws) if draws is not None else
                 [TorchDraws(s, device) for s in seed_list])
        sweep = _Sweep(init_fn, apply_fn, loss_fn, topology.to(device),
                       xs.to(device), ys.to(device),
                       x_test[: cfg.eval_samples].to(device),
                       y_test[: cfg.eval_samples].to(device), cfg, strategy,
                       draws, owner, snrs, device)
        return sweep.run(cfg.rounds, timers)
