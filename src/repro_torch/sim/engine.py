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

Observability (`repro_torch.obs`): ``telemetry=True``, a flag fixed for
the run, adds to the round a fresh full-shard forward for the per-client
loss, the strategy's ``telemetry`` hook and the channel-use ledger in the
carry (``"obs"``), and each round's `RoundTelemetry` to the history; with
it off the round is what it was.  ``checkpoint_dir`` runs the scanned
trajectory in segments (`_Checkpoints`): after each it saves the
replayer's buffers (the whole carry), the outputs so far and the draws'
state, and ``resume`` continues from one, bitwise the uninterrupted run.
``stream`` drains each round's record to the host while the run goes on
(`repro_torch.obs.stream.LiveTap`), with no host sync in the rounds.

Per-round metrics stay on the device until the run ends, unless a
``progress`` callback or a stream asks for them each round.
"""
from __future__ import annotations

import contextlib
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    read_checkpoint, save_checkpoint)
from repro_torch.core.channel import snr_db_to_noise_var
from repro_torch.core.cwfl import f32_scalar
from repro_torch.core.topology import Topology, TopologyConfig
from repro_torch.models.small import accuracy
from repro_torch.obs.stream import LiveTap, emit_sweep
from repro_torch.obs.telemetry import (RoundTelemetry, build_round_telemetry,
                                       init_ledger)
from repro_torch.optim import sgd
from repro_torch.sim.draws import (Draws, RoundDraws, TorchDraws, take_round,
                                   take_rounds)
from repro_torch.sim.faults import init_faults, quarantine_mask, step_faults
from repro_torch.sim.processes import (ChannelView, csi_perturbation,
                                       init_channel, step_and_view)
from repro_torch.sim.scenarios import Scenario, get_scenario
from repro_torch.sim.scheduling import init_schedule, participation_mask
from repro_torch.strategies import get_strategy
from repro_torch.training.local import make_local_runner
from repro_torch.utils.device import resolve_device
from repro_torch.utils.nest import (nest_map, nest_rebuild, nest_stack,
                                    nest_tensors, nest_vmap)
from repro_torch.utils.pytree import (tree_flatten, tree_map, tree_size,
                                      tree_unflatten)


@contextlib.contextmanager
def _reference_numerics():
    """The run's numerics, the caller's flags back after it: TF32 off (the
    JAX reference computes in full f32, and TF32 would keep ~3 digits),
    and cuDNN held to deterministic algorithms without autotuning, so a
    run replays its own bits as the JAX package's does on one backend
    (otherwise the CNN's convolution backward sums in an order that
    varies from run to run)."""
    cudnn = torch.backends.cudnn
    flags = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = flags


def _tree_where(mask: torch.Tensor, a, b):
    """Per-leaf ``where(mask > 0, a, b)``, ``mask`` indexing each leaf's
    leading axis (the K clients of a stacked tree, or one entry)."""
    a_leaves, treedef = tree_flatten(a)
    b_leaves, _ = tree_flatten(b)
    return tree_unflatten(treedef, [
        torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)) > 0, x, y)
        for x, y in zip(a_leaves, b_leaves)])


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
    """A nest (`repro_torch.utils.nest`) with its tensors on ``device``."""
    return nest_map(lambda x: x.to(device), obj)


def _copied(obj):
    """A nest with each of its tensors cloned."""
    return nest_map(lambda x: x.clone(), obj)


class _Replayer:
    """Runs a round body ``body(carry, draws, t) -> (carry, out)`` on fixed
    buffers: the carry lives in buffers that each round reads and then
    overwrites in place, and ``out`` (the round's metrics and telemetry, a
    nest of tensors) is copied out after the round.

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
        self.bufs = [x.clone() for x in nest_tensors(carry0)]
        self.graphs: dict = {}
        self.capture = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.capture else None
        self.rounds = 0

    def _phase(self, name: str):
        return _phase(self.timers, name)

    def state(self):
        """The carry as the buffers hold it now."""
        return nest_rebuild(self.carry, iter(self.bufs))

    def load(self, carry) -> None:
        """Overwrite the buffers with ``carry`` (a nest of the carry's
        structure: a checkpoint's), before the first round."""
        if self.rounds:
            raise RuntimeError("a carry is loaded before the first round")
        tensors = nest_tensors(carry)
        if len(tensors) != len(self.bufs):
            raise RuntimeError(f"the loaded carry has {len(tensors)} "
                               f"tensors, the buffers {len(self.bufs)}")
        for b, x in zip(self.bufs, tensors):
            b.copy_(x)

    def _step(self, draws, t: int):
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

        new_tensors = nest_tensors(new)
        if len(new_tensors) != len(self.bufs):
            raise RuntimeError(f"the round's carry has {len(new_tensors)} "
                               f"tensors, its buffers {len(self.bufs)}")
        new_tensors = [detached(x, b) for x, b in zip(new_tensors, self.bufs)]
        out = nest_map(detached, out)
        for b, x in zip(self.bufs, new_tensors):
            if x.shape != b.shape or x.dtype != b.dtype:
                raise RuntimeError(f"the round changed a carry tensor from "
                                   f"{tuple(b.shape)} {b.dtype} to "
                                   f"{tuple(x.shape)} {x.dtype}")
            if x is not b:
                b.copy_(x)
        return out

    def run(self, t: int, key, take_draws: Callable):
        """Round ``t``: its ``key``, and ``take_draws()`` its draws (a nest
        of tensors, taken inside the round's phase); returns its outputs,
        copied out of the round."""
        first = self.rounds == 0
        self.rounds += 1
        if not self.capture:
            with self._phase("trace_compile" if first else "execute"):
                return _copied(self._step(_on(take_draws(), self.device), t))
        if first:
            with self._phase("trace_compile"):
                draws = _on(take_draws(), self.device)
                current = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream), _host_syncs_raise():
                    out = _copied(self._step(draws, t))
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
                          for x in nest_tensors(draws)]
                graph = torch.cuda.CUDAGraph()
                # Only this thread's calls are checked during the
                # capture: a process group's watchdog thread (a body with
                # NCCL collectives) queries its events meanwhile.
                with torch.cuda.graph(graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = self._step(nest_rebuild(draws, iter(inputs)), t)
                self.graphs[key] = (graph, inputs, out)
        with self._phase("execute"):
            graph, inputs, out = self.graphs[key]
            for buf, x in zip(inputs, nest_tensors(draws)):
                buf.copy_(x)
            graph.replay()
            return _copied(out)

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


def _history(outs: list, consensus) -> dict[str, Any]:
    """The per-round metrics of a run (and its telemetry, if it records
    one), stacked on the device."""
    loss = torch.stack([o["loss"] for o in outs])
    acc = torch.stack([o["acc"] for o in outs])
    history = {"round": np.arange(1, len(outs) + 1), "train_loss": loss,
               "test_acc": acc, "final_params": consensus,
               "avg_acc": torch.mean(acc), "final_acc": acc[-1]}
    if "telemetry" in outs[0]:
        history["telemetry"] = nest_stack([o["telemetry"] for o in outs])
    return history


def _noise_var(topology: Topology, snr_db) -> float:
    """σ² of a run at overall SNR ``snr_db`` (``None``: the topology's)."""
    return (topology.noise_var if snr_db is None else
            snr_db_to_noise_var(topology.total_power, snr_db))


class _Dynamics:
    """A dynamic scenario's processes and its sync (the JAX engine's
    ``dynamic_sync``), over one trajectory or, with ``batch`` = B, over B
    trajectories of a sweep.  Each round, in JAX's order: the channel
    step and its view; the schedule's mask; the fault step (``alive``,
    transmit outages folded into the mask, quarantine); the CSI error if
    the strategy water-fills; re-clustering every ``recluster_every``
    rounds if it has a cluster plan; the head-failure handoff; the state
    rebuild; the aggregation; the receive-side fold, unless the
    strategy's ``receive_mask`` is ``None``.  The processes' states ride
    in the round's carry (:meth:`carry0`); each round records the live
    nodes, the mask's mass, the quarantined clients and, for a strategy
    with a cluster plan, the heads.  With ``telemetry`` the sync also
    hands the round's telemetry the re-clustering predicate (an f32
    tensor) and the fault plane's events (JAX's ``fault_*`` extras).

    Over B trajectories every process state, draw and record has a
    leading B, the clients are stacked beside K (rows b·K .. b·K + K − 1,
    as `_Sweep` stacks them), the channel's step and view run on the
    stack (one kernel launch), and each other per-trajectory step (the
    schedule, the faults, the strategy's hooks) runs once for all B under
    ``torch.func.vmap`` (`repro_torch.utils.nest.nest_vmap`); the
    row-wise steps (quarantine, the folds) run on the stacked rows, and
    the aggregation is the strategy's batched sync, one kernel launch.
    Each trajectory gets the bits of its lone run, but for one place
    where JAX's own sweep parts from its lone run and the port follows
    JAX: an evolving channel's first state, whose pathloss a sweep's
    setup takes under ``jit`` and a run eagerly (`init_channel`'s
    ``mode``).  The two part in the last bit at some links of most
    topologies (2 of 64 at JAX's topology seed 7, K = 8), so such a
    sweep's channel state, and any record that comes to turn on it, is
    its lone run's only where the two pathlosses agree; at K = 50 most
    trajectories of a cluster-churn sweep part from their lone runs in
    the last bits of the loss.

    ``state0``: the offline state (stacked over B); ``noise_var``: σ² as
    an f32 tensor, () or (B,); ``channel_init``: the channel process's
    first-waypoint uniforms, (K, 2) or (B, K, 2), for a scenario whose
    channel evolves."""

    def __init__(self, scenario: Scenario, strategy, topology: Topology,
                 topo_cfg: Optional[TopologyConfig], cfg, state0,
                 noise_var: torch.Tensor,
                 channel_init: Optional[torch.Tensor], device,
                 batch: Optional[int] = None, telemetry: bool = False):
        self.scenario, self.strategy = scenario, strategy
        self.telemetry = telemetry
        self.topo_cfg, self.num_clusters = topo_cfg, cfg.num_clusters
        self.state0, self.noise_var, self.device = state0, noise_var, device
        self.batch = batch
        self.lead = () if batch is None else (batch,)
        self.K = K = topology.num_clients
        self.view = self._each(ChannelView(
            link_gain=topology.link_gain, link_snr=topology.link_snr,
            adjacency=topology.adjacency))
        self._carry0 = {}
        if not scenario.schedule.is_trivial:
            self._carry0["sched"] = self._each(init_schedule(
                scenario.schedule, K, device))
        if not scenario.faults.is_trivial:
            self._carry0["faults"] = self._each(init_faults(
                scenario.faults, K, device))
        if scenario.channel.evolves_geometry:
            # A sweep's setup is traced under jit; a run's is eager.
            self._carry0["chan"] = init_channel(
                topology, topo_cfg, channel_init,
                mode="eager" if batch is None else "jit")
        self.reclusters = (strategy.reclusters
                           and scenario.recluster_every > 0)
        if self.reclusters:
            self._carry0["plan"] = state0.plan

    def _each(self, nest):
        """``nest`` for every trajectory: its tensors with the leading
        axis, copied."""
        if self.batch is None:
            return nest
        return nest_map(lambda x: x.expand(self.lead + x.shape).clone(),
                        nest)

    def _map(self, fn: Callable, *args):
        """``fn`` of one trajectory, over every trajectory."""
        return fn(*args) if self.batch is None else nest_vmap(fn, *args)

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
        and the processes' states, ``rd`` the round's draws (each
        trajectory's, over B).  Returns ``(new_stacked, consensus,
        updates, record, seen)``: ``updates`` the processes' new states,
        ``seen`` what the round's telemetry reads — the rebuilt state, the
        mask and, with ``telemetry``, the re-clustering predicate and the
        fault events."""
        sc, strategy, tcfg = self.scenario, self.strategy, self.topo_cfg
        K, lead, dev = self.K, self.lead, self.device
        pre_round, consensus = carry["stacked"], carry["consensus"]
        updates = {}
        view = self.view
        if "chan" in carry:
            # One launch for every trajectory (its leading axes batch).
            updates["chan"], view = step_and_view(carry["chan"], sc.channel,
                                                  tcfg, rd.channel)

        mask = None
        if "sched" in carry:
            mask, updates["sched"] = self._map(
                lambda s, u: participation_mask(sc.schedule, s, t, u),
                carry["sched"], rd.schedule)

        alive, fault_extras = None, None
        quarantined = torch.zeros(lead, device=dev)
        if "faults" in carry:
            # Transmit outages fold into the mask; a quarantined client
            # transmits nothing and keeps its pre-round params (0 × NaN =
            # NaN, so masking alone cannot contain a non-finite update).
            updates["faults"], fview = self._map(
                lambda f, u: step_faults(f, sc.faults, u), carry["faults"],
                rd.faults)
            alive = fview.alive
            mask = fview.tx_ok if mask is None else mask * fview.tx_ok
            if sc.faults.divergence_guard:
                q = quarantine_mask(trained, sc.faults.quarantine_norm)
                trained = _tree_where(q, trained, pre_round)
                q = q.reshape(mask.shape)
                mask = mask * q
                quarantined = K - q.sum(dim=-1)
            if self.telemetry:
                fault_extras = {
                    "alive": alive, "tx_ok": fview.tx_ok,
                    "burst": fview.burst, "deep_fade": fview.deep_fade,
                    "quarantined": (torch.sum(1.0 - q, dim=-1)
                                    if sc.faults.divergence_guard
                                    else torch.zeros(lead, device=dev))}

        csi = (csi_perturbation(rd.csi, sc.channel.csi_error_std)
               if rd.csi is not None else None)

        plan = None
        if self.reclusters:
            if self.recluster_round(t):
                updates["plan"] = self._map(
                    lambda v, first: strategy.recluster(
                        v, self.num_clusters, first), view, rd.recluster)
            plan = updates.get("plan", carry["plan"])
        if alive is not None:
            plan = self._map(strategy.on_head_failure, self.state0, plan,
                             view, alive)

        state = self._map(
            lambda s0, v, nv, c, m, p, a: strategy.state_from_view(
                s0, v, nv, csi=c, mask=m, plan=p, alive=a),
            self.state0, view, self.noise_var, csi, mask, plan, alive)
        aggregate = (strategy.aggregate if self.batch is None
                     else strategy.aggregate_batch)
        new, new_consensus = aggregate(trained, state, rd.noise, mask=mask,
                                       alive=alive)
        recv = (self._map(lambda s, m, a: strategy.receive_mask(
                    s, m, alive=a), state, mask, alive)
                if mask is not None else None)
        if recv is not None:
            # Absent clients keep their locally trained params, receivers
            # forced present keep the aggregate; if nobody took part the
            # sync is skipped and the last consensus stands (which also
            # discards FedAvg's 0/0 weights) — decided on the device, for
            # each trajectory.
            present = (torch.sum(mask, dim=-1) > 0).to(torch.float32)
            new = _tree_where((recv * present[..., None]).reshape(-1), new,
                              trained)
            new_consensus = _tree_where(present.reshape(-1), new_consensus,
                                        consensus)

        everyone = torch.full(lead, float(K), device=dev)
        record = {"alive": torch.sum(alive, dim=-1) if alive is not None
                  else everyone,
                  "mask_mass": torch.sum(mask, dim=-1) if mask is not None
                  else everyone.clone(),
                  "quarantined": quarantined}
        if strategy.reclusters:
            record["heads"] = state.plan.heads
        seen = {"state": state, "mask": mask, "fault_extras": fault_extras,
                "reclustered": None}
        if self.telemetry and self.reclusters:
            seen["reclustered"] = torch.full(
                lead, float(self.recluster_round(t)), device=dev)
        return new, new_consensus, updates, record, seen


class _Trajectory:
    """One trajectory, prepared: its offline state, initial carry, the
    draws of each round and the round body, on ``device``; with
    ``telemetry`` the round also records its `RoundTelemetry` and carries
    the channel-use ledger."""

    def __init__(self, init_fn, apply_fn, loss_fn, topology, xs, ys, x_ev,
                 y_ev, cfg, scenario: Scenario, topo_cfg, strategy,
                 draws: Draws, device, telemetry: bool = False):
        self.apply_fn, self.cfg, self.strategy = apply_fn, cfg, strategy
        self.loss_fn, self.telemetry = loss_fn, telemetry
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
        self.dynamics = None
        if not scenario.is_static:
            self.dynamics = _Dynamics(
                scenario, strategy, topology, topo_cfg, cfg, self.state,
                f32_scalar(_noise_var(topology, cfg.snr_db), device),
                (draws.channel_init(K).to(device)
                 if scenario.channel.evolves_geometry else None), device,
                telemetry=telemetry)
            self.carry0.update(self.dynamics.carry0())
        if telemetry:
            self.carry0["obs"] = init_ledger(device)

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
        """One round: local training, the sync, the eval, and with
        telemetry the round's `RoundTelemetry`.  Returns the new carry and
        the round's outputs."""
        trained, opt_state, client_loss = self.local_run(
            carry["stacked"], carry["opt"], self.xs, self.ys, rd.idx)
        new_carry = dict(carry, opt=opt_state)
        with torch.no_grad():
            if self.dynamics is None:
                stacked, consensus = self.strategy.aggregate(
                    trained, self.state, rd.noise)
                record = {}
                seen = {"state": self.state, "mask": None,
                        "fault_extras": None, "reclustered": None}
            else:
                stacked, consensus, updates, record, seen = \
                    self.dynamics.sync(t, carry, trained, rd)
                new_carry.update(updates)
            acc = accuracy(self.apply_fn(consensus, self.x_ev), self.y_ev)
            out = {"loss": torch.mean(client_loss), "acc": acc, **record}
            if self.telemetry:
                # A fresh full-shard forward on the locally trained params,
                # as JAX's, never a second reduction over the minibatch
                # losses of the round.
                out["telemetry"], new_carry["obs"] = build_round_telemetry(
                    self.strategy, seen["state"],
                    losses=self.loss_fn(trained, self.xs, self.ys),
                    stacked=trained, new_stacked=stacked,
                    consensus=consensus, mask=seen["mask"],
                    num_clients=self.K, num_clusters=self.cfg.num_clusters,
                    ledger=carry["obs"], reclustered=seen["reclustered"],
                    fault_extras=seen["fault_extras"])
        new_carry.update(stacked=stacked, consensus=consensus)
        return new_carry, out


def _records(outs: list, static: bool, dim: int = 0) -> Optional[dict]:
    """A dynamic run's per-round records, stacked along ``dim`` (the
    rounds' axis: 0 for one trajectory, 1 behind a sweep's B)."""
    if static:
        return None
    keys = [k for k in outs[0] if k not in ("loss", "acc", "telemetry")]
    return {k: torch.stack([o[k] for o in outs], dim=dim) for k in keys}


# ---------------------------------------------------------------------------
# The scanned trajectory's driver: checkpoints and the live stream.
# ---------------------------------------------------------------------------

def check_obs_args(*, mode: str, telemetry: bool, timers, checkpoint_dir,
                   resume: bool, stop_after, stream) -> None:
    """JAX's argument checks of telemetry, checkpoints and the stream."""
    if checkpoint_dir is None and (resume or stop_after is not None):
        raise ValueError(
            "resume/stop_after need checkpoint_dir — there is nothing to "
            "restore from or checkpoint into")
    if stream is not None:
        if not telemetry:
            raise ValueError(
                "stream= drains RoundTelemetry live and needs "
                "telemetry=True")
        if mode != "scan":
            raise ValueError(
                "stream= taps the scanned trajectory; mode='loop' already "
                "has a live per-round progress callback")
        if stream.escalates and checkpoint_dir is None:
            raise ValueError(
                "abort-on-alert escalates via the checkpoint machinery "
                "(checkpoint-then-stop, resumable); pass checkpoint_dir")
    if checkpoint_dir is not None:
        if mode != "scan":
            raise ValueError(
                "checkpointing chunks the scanned trajectory; "
                "mode='loop' is not supported (and needs no resume — it "
                "is already a host loop)")
        if timers is not None:
            raise ValueError(
                "timers profile a single-segment run; combine them with "
                "checkpointing and the phases stop meaning anything")


def checkpoint_manifest(directory, cfg, scenario, strategy_name: str,
                        resume: bool, write: bool = True) -> None:
    """Stamp (or validate) the checkpoint directory's run identity: the
    first save writes a `repro_torch.obs.manifest` record whose
    ``config_hash`` covers (config, scenario, strategy); every later save
    or resume against the directory must hash identically, since resuming
    under another protocol would splice incompatible histories.
    ``write=False`` validates only (the ranks of a client-sharded run
    other than the one that writes)."""
    from repro_torch.obs.manifest import (build_manifest, config_hash,
                                          to_jsonable)

    directory = Path(directory)
    chash = config_hash(to_jsonable(cfg), to_jsonable(scenario),
                        strategy_name)
    path = directory / "manifest.json"
    if path.exists():
        recorded = json.loads(path.read_text()).get("config_hash")
        if recorded != chash:
            raise ValueError(
                f"checkpoint directory {directory} belongs to a different "
                f"run protocol (manifest config_hash {recorded!r} != this "
                f"run's {chash!r}); use a fresh checkpoint dir or the "
                f"original config/scenario/strategy")
    elif resume:
        raise FileNotFoundError(
            f"resume: {path} not found — nothing to resume from")
    elif write:
        directory.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            build_manifest(cfg, scenario, strategy_name,
                           extra={"kind": "trajectory-checkpoint"}),
            indent=2, sort_keys=True))


def _outputs_from(leaves: dict, step: int, device) -> list:
    """The first ``step`` rounds' outputs from a checkpoint's leaves named
    ``out/...`` (`repro_torch.checkpoint.read_checkpoint`): the nest of
    stacked outputs rebuilt from the leaf names, a level whose names are
    all ``.field`` a `RoundTelemetry`, then one nest a round."""
    tree: dict = {}
    for name, x in leaves.items():
        if name.startswith("out/"):
            *path, last = name.split("/")[1:]
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = x.to(device)

    def build(node):
        if isinstance(node, torch.Tensor):
            return node
        built = {k: build(v) for k, v in node.items()}
        if built and all(k.startswith(".") for k in built):
            fields = {k[1:]: v for k, v in built.items()}
            return RoundTelemetry(**{"extras": {}, **fields})
        return built

    stacked = build(tree)
    return [nest_map(lambda x, i=i: x[i], stacked) for i in range(step)]


class _Checkpoints:
    """The checkpointed driver's side of one run (JAX's
    ``_run_scan_checkpointed``): the T rounds run in segments of
    ``every`` (0: one segment); after each, the replayer's buffers (the
    whole carry), the outputs so far and the draws' state are saved under
    ``step_<rounds done>`` (`repro_torch.checkpoint`).  ``resume`` loads
    ``resume_step`` (default: the latest) into the buffers and the draws
    before the first round, which then runs as any run's warm-up; the
    scan is bitwise its loop, so the resumed history is bitwise the
    uninterrupted one.  ``stop_after=r`` stops at the first boundary ≥ r.

    A client-sharded run (`repro_torch.sim.sharded`) passes ``to_disk``
    (its rows gathered into the whole carry), ``from_disk`` (this rank's
    rows of a loaded one), ``template`` (the whole carry's structure),
    ``writer`` (rank 0 alone writes), ``barrier`` (after a save) and
    ``agree`` (rank 0's stop decision, for every rank)."""

    def __init__(self, directory, every: int, rounds: int, *, resume: bool,
                 resume_step: Optional[int], stop_after: Optional[int],
                 draws, template, to_disk: Callable = lambda c: c,
                 from_disk: Callable = lambda c: c, writer: bool = True,
                 barrier: Callable = lambda: None,
                 agree: Callable = lambda stop: stop):
        if not (callable(getattr(draws, "state", None))
                and callable(getattr(draws, "set_state", None))):
            raise TypeError(
                "a checkpoint saves the draws' state: the run's draws need "
                "state() and set_state() (repro_torch.sim.draws.Draws)")
        self.directory = Path(directory)
        self.every = (rounds if every is None or int(every) <= 0
                      else min(int(every), rounds))
        self.rounds, self.resume, self.resume_step = rounds, resume, resume_step
        self.stop_after, self.draws, self.template = stop_after, draws, template
        self.to_disk, self.from_disk = to_disk, from_disk
        self.writer, self.barrier, self.agree = writer, barrier, agree
        self.saves: list = []          # (step, seconds) of each save
        self.resumed_from: Optional[int] = None

    def restore(self, rep: "_Replayer", device) -> tuple[int, list]:
        """``(rounds done, their outputs)``: 0 and none unless resuming,
        else the checkpoint's, its carry loaded into ``rep``."""
        if not self.resume:
            return 0, []
        step = (self.resume_step if self.resume_step is not None
                else latest_step(self.directory))
        if step is None:
            raise FileNotFoundError(
                f"resume: no checkpoint steps in {self.directory}")
        if not 0 < step <= self.rounds:
            raise ValueError(
                f"resume: checkpoint step {step} outside this run's "
                f"1..{self.rounds} round range")
        payload = load_checkpoint(
            self.directory, {"carry": self.template,
                             "draws": self.draws.state()}, step=step)
        rep.load(self.from_disk(payload["carry"]))
        self.draws.set_state(payload["draws"])
        self.resumed_from = step
        return step, _outputs_from(read_checkpoint(self.directory, step),
                                   step, device)

    def save(self, step: int, rep: "_Replayer", outs: list) -> None:
        t0 = time.perf_counter()
        carry = self.to_disk(rep.state())
        if self.writer:
            save_checkpoint(self.directory, step,
                            {"carry": carry, "out": nest_stack(outs),
                             "draws": self.draws.state()})
        self.barrier()
        self.saves.append((step, time.perf_counter() - t0))

    def record(self) -> dict:
        """What the history reports of the checkpoints."""
        return {"saves": [list(x) for x in self.saves],
                "resumed_from": self.resumed_from}


def _no_host_sync(device):
    """On a CUDA device, a host sync raises in the block."""
    return (_host_syncs_raise() if device.type == "cuda"
            else contextlib.nullcontext())


def scan_rounds(body: Callable, carry0, device, rounds: int, key: Callable,
                take_draws: Callable, *, timers=None,
                ckpt: Optional[_Checkpoints] = None,
                tap: Optional[LiveTap] = None):
    """Rounds ``0 .. rounds − 1`` of ``body`` through a `_Replayer`: round
    t's Python-level branches ``key(t)``, its draws ``take_draws(t)``.
    With ``ckpt`` the rounds run in its segments, a save after each, a
    resumed run starting where its checkpoint stopped.  With ``tap`` each
    round's record is pushed to the live stream after it, and the stream
    takes the records whose copies have landed before each round (a host
    sync raises meanwhile), and all of them at each boundary and at the
    end; at a boundary the monitor's escalation is polled, after the
    save.  The tap's work is timed with the round it follows (``timers``:
    the first round's under ``trace_compile``, the rest under
    ``execute``).  Returns ``(final carry, outputs of the rounds run)``."""
    rep = _Replayer(body, carry0, device, timers)
    pos, outs = (0, []) if ckpt is None else ckpt.restore(rep, device)
    every = rounds if ckpt is None else ckpt.every
    while pos < rounds:
        end = min(pos + every, rounds)
        for t in range(pos, end):
            if tap is not None and rep.rounds:
                with _phase(timers, "execute"), _no_host_sync(device):
                    tap.poll()
            out = rep.run(t, key(t), lambda t=t: take_draws(t))
            outs.append(out)
            if tap is not None:
                with (_phase(timers, "execute" if rep.rounds > 1
                             else "trace_compile"),
                      _no_host_sync(device)):
                    tap.push(t, out["loss"], out["acc"], out["telemetry"])
        pos = end
        if ckpt is None:
            continue
        ckpt.save(pos, rep, outs)
        if (ckpt.stop_after is not None and pos >= int(ckpt.stop_after)
                and pos < rounds):
            break
        if tap is not None:
            tap.drain()
        abort = tap is not None and tap.stream.should_abort
        if ckpt.agree(abort) and pos < rounds:
            break
    rep.finish()
    if tap is not None:
        tap.drain()
    return rep.state(), outs


def _resolve(scenario: Union[Scenario, str, None], cfg,
             topo_cfg: Optional[TopologyConfig]):
    """``(scenario, strategy)`` of a run, warning when the scenario pins
    another strategy than ``cfg.strategy`` (which wins, as in JAX)."""
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
            UserWarning, stacklevel=3)
    if scenario.channel.evolves_geometry and topo_cfg is None:
        raise ValueError(
            "dynamic-channel scenarios need the TopologyConfig that "
            "generated the topology (geometry statics: area, d0, ς, "
            "outage threshold)")
    return scenario, strategy


def run_rounds(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
               topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
               x_test: torch.Tensor, y_test: torch.Tensor, cfg,
               scenario: Union[Scenario, str, None] = None,
               topo_cfg: Optional[TopologyConfig] = None,
               mode: str = "scan",
               progress: Optional[Callable] = None,
               draws: Optional[Draws] = None,
               device=None, shard: Optional[str] = None,
               group=None, timers=None, telemetry: bool = False,
               checkpoint_dir=None, checkpoint_every: int = 0,
               resume: bool = False, resume_step: Optional[int] = None,
               stop_after: Optional[int] = None,
               stream=None) -> dict[str, Any]:
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
    run_rounds_client_sharded`), in either mode (the scan captures the
    round's collectives); static CWFL scenarios.

    ``telemetry=True`` (`repro_torch.obs`): record each round's
    `RoundTelemetry` under ``history["telemetry"]`` (leading T), in either
    mode; with it off the run is what it is without it, bit for bit.

    Checkpoint and resume (scan mode, no ``timers``): ``checkpoint_dir``
    saves the whole carry, the outputs so far and the draws' state every
    ``checkpoint_every`` rounds (0: once, at the end), the directory
    stamped with the run's config hash; ``resume=True`` continues from the
    latest step (or ``resume_step``), bitwise the uninterrupted run;
    ``stop_after=r`` stops at the first boundary ≥ r.  The draws must
    have ``state``/``set_state`` (a `TorchDraws` keeps its generators').
    ``history["checkpoint"]`` holds each save's step and seconds.

    ``stream`` (scan mode, needs ``telemetry``): a
    `repro_torch.obs.RoundStream` that takes each round's record while
    the run goes on (`repro_torch.obs.stream.LiveTap`), with absolute
    round indices; a monitor that escalates needs ``checkpoint_dir`` and
    stops the run at a boundary, after its save.

    The history holds per-round ``train_loss`` and ``test_acc`` (T,) and the
    final consensus; a dynamic scenario adds ``scenario``: per round, the
    live nodes, the mask's mass, the quarantined clients (T,) and, for a
    strategy with a cluster plan, the heads (T, C).
    """
    if mode not in ("scan", "loop"):
        raise ValueError(f"mode must be 'scan' or 'loop', got {mode!r}")
    if mode == "scan" and progress is not None:
        raise ValueError(
            "progress= reports each round as it ends, which the scanned "
            "trajectory does not stop for; pass mode='loop'")
    check_obs_args(mode=mode, telemetry=telemetry, timers=timers,
                   checkpoint_dir=checkpoint_dir, resume=resume,
                   stop_after=stop_after, stream=stream)
    if shard is not None:
        if shard != "clients":
            raise ValueError(
                f"run_rounds shards the client axis only (shard='clients'); "
                f"got {shard!r} — trajectory sharding (shard='mc') lives in "
                f"run_monte_carlo")
        from repro_torch.sim import sharded
        return sharded.run_rounds_client_sharded(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, scenario=scenario, group=group, progress=progress,
            draws=draws, device=device, mode=mode, timers=timers,
            telemetry=telemetry, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            resume_step=resume_step, stop_after=stop_after, stream=stream)
    scenario, strategy = _resolve(scenario, cfg, topo_cfg)
    device = resolve_device(device)
    with _reference_numerics():
        draws = draws if draws is not None else TorchDraws(cfg.seed, device)
        traj = _Trajectory(
            init_fn, apply_fn, loss_fn, topology.to(device), xs.to(device),
            ys.to(device), x_test[: cfg.eval_samples].to(device),
            y_test[: cfg.eval_samples].to(device), cfg, scenario, topo_cfg,
            strategy, draws, device, telemetry=telemetry)
        ckpt = None
        if mode == "loop":
            outs, carry = [], traj.carry0
            for t in range(cfg.rounds):
                with _phase(timers, "execute"):
                    carry, out = traj.body(carry, traj.round_draws(t), t)
                    if timers is not None and device.type == "cuda":
                        torch.cuda.synchronize(device)
                outs.append(out)
                if progress is not None:
                    progress(t + 1, float(out["loss"]), float(out["acc"]))
        else:
            if checkpoint_dir is not None:
                checkpoint_manifest(checkpoint_dir, cfg, scenario,
                                    strategy.name, resume)
                ckpt = _Checkpoints(
                    checkpoint_dir, checkpoint_every, cfg.rounds,
                    resume=resume, resume_step=resume_step,
                    stop_after=stop_after, draws=draws,
                    template=traj.carry0)
            tap = (LiveTap(stream, seed=cfg.seed, snr_db=cfg.snr_db,
                           device=device) if stream is not None else None)
            carry, outs = scan_rounds(
                traj.body, traj.carry0, device, cfg.rounds, traj.key,
                traj.round_draws, timers=timers, ckpt=ckpt, tap=tap)

        history = _history(outs, carry["consensus"])
        records = _records(outs, scenario.is_static)
        if records is not None:
            history["scenario"] = records
        if ckpt is not None:
            history["checkpoint"] = ckpt.record()
        return history


# ---------------------------------------------------------------------------
# A sweep of trajectories, batched.
# ---------------------------------------------------------------------------

class _Sweep:
    """B trajectories run together: trajectory b is seed
    ``seeds[owner[b]]`` (its draws ``draws[owner[b]]``) at SNR ``snrs[b]``.
    Their clients are stacked beside K (B·K rows, b-major, each reading
    its shard through the local runner's client → shard map), their
    states along a leading axis (`Strategy.init_batch`), and every round
    runs one set of launches for all of them: local training, the
    batched sync (`Strategy.aggregate_batch`; under a dynamic scenario
    `_Dynamics` over B), the batched eval.  A seed's trajectories share
    its draws, as JAX's inner ``vmap`` over the SNR axis shares its
    keys.  With ``telemetry`` each trajectory's full-shard forward, its
    telemetry hook and its ledger run on its own slices, at the lone
    run's shapes, one trajectory after another in the round: each gets
    the bits of its lone run's `RoundTelemetry`.  (Mapped with
    ``torch.func.vmap``, the hook gave 39 of 40 trajectories of the
    head-failure sweep other bits than their lone runs on the H100.)"""

    def __init__(self, init_fn, apply_fn, loss_fn, topology, xs, ys, x_ev,
                 y_ev, cfg, scenario: Scenario, topo_cfg, strategy,
                 draws: Sequence[Draws], owner: Sequence[int],
                 snrs: Sequence, device, telemetry: bool = False):
        self.apply_fn, self.cfg, self.strategy = apply_fn, cfg, strategy
        self.loss_fn, self.telemetry = loss_fn, telemetry
        self.scenario, self.draws, self.device = scenario, list(draws), device
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
        self.dynamics = None
        if not scenario.is_static:
            channel_init = None
            if scenario.channel.evolves_geometry:
                channel_init = torch.stack([dr.channel_init(K).to(device)
                                            for dr in self.draws])[
                                                self.owner]
            self.dynamics = _Dynamics(
                scenario, strategy, topology, topo_cfg, cfg, self.state,
                torch.stack([f32_scalar(_noise_var(topology, snr), device)
                             for snr in snrs]), channel_init, device,
                batch=B, telemetry=telemetry)
            self.carry0.update(self.dynamics.carry0())
        if telemetry:
            self.carry0["obs"] = nest_map(lambda x: x.expand(B).clone(),
                                          init_ledger(device))

    def key(self, t: int) -> tuple:
        return () if self.dynamics is None else self.dynamics.key(t)

    def round_draws(self, t: int) -> RoundDraws:
        """Round ``t``'s draws of every seed, stacked along a leading seed
        axis (`repro_torch.sim.draws.take_rounds`), on the run's device."""
        cfg = self.cfg
        return _on(take_rounds(
            self.draws, t, strategy=self.strategy, scenario=self.scenario,
            num_clients=self.K, steps=self.steps, batch=cfg.batch_size,
            n_k=self.n_k, num_clusters=cfg.num_clusters, d=self.d,
            recluster=(self.dynamics is not None
                       and self.dynamics.recluster_round(t))), self.device)

    def body(self, carry: dict, rd: RoundDraws, t: int):
        """One round of the B trajectories."""
        B, K = self.B, self.K
        rd = nest_map(lambda x: x[self.owner], rd)   # each trajectory's
        idx = rd.idx.reshape((B * K,) + rd.idx.shape[2:])
        trained, opt_state, client_loss = self.local_run(
            carry["stacked"], carry["opt"], self.xs, self.ys, idx, self.rows)
        new_carry = dict(carry, opt=opt_state)
        with torch.no_grad():
            if self.dynamics is None:
                stacked, consensus = self.strategy.aggregate_batch(
                    trained, self.state, rd.noise)
                record = {}
                seen = {"state": self.state, "mask": None,
                        "fault_extras": None, "reclustered": None}
            else:
                stacked, consensus, updates, record, seen = \
                    self.dynamics.sync(t, carry, trained, rd)
                new_carry.update(updates)
            x_ev = self.x_ev.expand((B,) + self.x_ev.shape)
            acc = accuracy(self.apply_fn(consensus, x_ev), self.y_ev)
            out = {"loss": torch.mean(client_loss.reshape(B, K), dim=1),
                   "acc": acc, **record}
            if self.telemetry:
                out["telemetry"], new_carry["obs"] = self._telemetry(
                    carry["obs"], trained, stacked, consensus, seen)
        new_carry.update(stacked=stacked, consensus=consensus)
        return new_carry, out

    def _telemetry(self, ledger, trained, stacked, consensus, seen):
        """The round's `RoundTelemetry` of every trajectory (leading B) and
        the ledgers advanced, each trajectory's from its own slices."""
        B, K = self.B, self.K

        def rows(tree):   # (B·K, ...) leaves -> (B, K, ...)
            return tree_map(lambda x: x.reshape((B, K) + x.shape[1:]),
                            tree)

        inputs = {"state": seen["state"], "trained": rows(trained),
                  "new": rows(stacked), "consensus": consensus,
                  "mask": seen["mask"], "ledger": ledger,
                  "reclustered": seen["reclustered"],
                  "fault_extras": seen["fault_extras"]}
        out = []
        for b in range(B):
            x = nest_map(lambda t, b=b: t[b], inputs)
            out.append(build_round_telemetry(
                self.strategy, x["state"],
                losses=self.loss_fn(x["trained"], self.xs, self.ys),
                stacked=x["trained"], new_stacked=x["new"],
                consensus=x["consensus"], mask=x["mask"], num_clients=K,
                num_clusters=self.cfg.num_clusters, ledger=x["ledger"],
                reclustered=x["reclustered"],
                fault_extras=x["fault_extras"]))
        return nest_stack(out)

    def run(self, rounds: int, timers=None):
        """The sweep's ``(loss, acc, records, telemetry)``: loss and
        accuracy (B, rounds), the scenario's records (B, rounds[, C]) or
        ``None``, the `RoundTelemetry` (leading B, rounds) or ``None``."""
        _, outs = scan_rounds(self.body, self.carry0, self.device, rounds,
                              self.key, self.round_draws, timers=timers)
        return (torch.stack([o["loss"] for o in outs], dim=1),
                torch.stack([o["acc"] for o in outs], dim=1),
                _records(outs, self.scenario.is_static, dim=1),
                (nest_stack([o["telemetry"] for o in outs], dim=1)
                 if self.telemetry else None))


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
                    device=None, telemetry: bool = False,
                    stream=None) -> dict[str, Any]:
    """Monte-Carlo grid: ``seeds`` × ``snr_grid`` full trajectories, run as
    one batch (JAX vmaps them into one jit): their clients stacked beside
    K, one set of launches a round for all of them, the round captured as
    in `run_rounds`'s scan mode.  Any registered scenario: a dynamic
    one's processes run batched over the trajectories (`_Dynamics`), a
    re-clustering or straggler round a graph of its own.

    ``snr_grid`` defaults to ``scenario.snr_grid`` when the scenario
    defines one (e.g. ``snr-sweep``); ``None``/empty sweeps only seeds, at
    ``cfg.snr_db``.  The seeds are ``cfg.seed + arange(seeds)``; a seed's
    SNR points share its draws.  ``draws``: one `Draws` for each seed
    (default: `TorchDraws` of each seed on ``device``).  ``shard="mc"``
    splits the flattened seeds × SNR grid over the ranks of the
    ``torch.distributed`` group ``group`` (`repro_torch.sim.sharded.
    monte_carlo_sharded`), each rank running its chunk as one batch.
    ``timers``: as `run_rounds`'s.  ``topo_cfg``: as `run_rounds`'s.
    ``telemetry=True``: each trajectory's `RoundTelemetry`, that of its
    lone run, under ``history["telemetry"]`` (leading (S[, G], T)).
    ``stream`` (needs ``telemetry``): after the run, one record per
    trajectory and round, tagged (seed, snr_db, round), as JAX's
    post-scan tap emits them (under ``shard="mc"``, rank 0's chunk).

    Returns ``train_loss``/``test_acc`` of shape (S, T) or (S, G, T) on
    the device, ``final_acc`` (S[, G]), ``seeds`` (S,) and ``snr_grid``
    ((G,) f32, or ``None``); a dynamic scenario adds ``scenario``, the
    records of `run_rounds` for every trajectory: (S[, G], T), the heads
    (S[, G], T, C).
    """
    scenario, strategy = _resolve(scenario, cfg, topo_cfg)
    seed_list, grid = _sweep_grid(cfg, scenario, seeds, snr_grid)
    if draws is not None and len(draws) != seeds:
        raise ValueError(f"draws= needs one Draws for each of the {seeds} "
                         f"seeds, got {len(draws)}")
    if stream is not None and not telemetry:
        raise ValueError(
            "stream= drains RoundTelemetry live and needs telemetry=True")
    if shard is not None:
        if shard != "mc":
            raise ValueError(
                f"run_monte_carlo shards the trajectory grid only "
                f"(shard='mc'); got {shard!r} — client-axis sharding "
                f"(shard='clients') lives in run_rounds")
        from repro_torch.sim import sharded
        loss, acc, records, tele = sharded.monte_carlo_sharded(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, scenario, topo_cfg, strategy, seed_list, grid, group=group,
            timers=timers, draws=draws, device=device, telemetry=telemetry,
            stream=stream)
    else:
        device = resolve_device(device)
        G = 1 if grid is None else len(grid)
        owner = [i for i in range(seeds) for _ in range(G)]
        snrs = [cfg.snr_db] * seeds if grid is None else grid * seeds
        loss, acc, records, tele = _run_sweep(
            init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
            cfg, scenario, topo_cfg, strategy, seed_list, owner, snrs, draws,
            device, timers, telemetry=telemetry)
        if stream is not None:
            emit_sweep(stream, [seed_list[i] for i in owner], snrs, loss,
                       acc, tele)
    shape = (seeds,) if grid is None else (seeds, len(grid))
    history = {"train_loss": loss.reshape(shape + (cfg.rounds,)),
               "test_acc": acc.reshape(shape + (cfg.rounds,)),
               "seeds": torch.tensor(seed_list),
               "snr_grid": (None if grid is None
                            else torch.tensor(grid, dtype=torch.float32))}
    history["final_acc"] = history["test_acc"][..., -1]
    if records is not None:
        history["scenario"] = {k: v.reshape(shape + v.shape[1:])
                               for k, v in records.items()}
    if tele is not None:
        history["telemetry"] = nest_map(
            lambda x: x.reshape(shape + x.shape[1:]), tele)
    return history


def _run_sweep(init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
               cfg, scenario: Scenario, topo_cfg, strategy,
               seed_list: Sequence[int], owner: Sequence[int],
               snrs: Sequence, draws: Optional[Sequence[Draws]], device,
               timers=None, telemetry: bool = False):
    """The trajectories ``(seed_list[owner[b]], snrs[b])`` as one batch on
    ``device``; ``draws`` (one for each of ``seed_list``, or ``None``:
    `TorchDraws` of each seed).  Returns ``(loss, acc, records,
    telemetry)`` (`_Sweep.run`)."""
    with _reference_numerics():
        draws = (list(draws) if draws is not None else
                 [TorchDraws(s, device) for s in seed_list])
        sweep = _Sweep(init_fn, apply_fn, loss_fn, topology.to(device),
                       xs.to(device), ys.to(device),
                       x_test[: cfg.eval_samples].to(device),
                       y_test[: cfg.eval_samples].to(device), cfg, scenario,
                       topo_cfg, strategy, draws, owner, snrs, device,
                       telemetry=telemetry)
        return sweep.run(cfg.rounds, timers)
