"""The paper's strategies on the Strategy protocol (port of
`repro.strategies.builtin`).

* ``cwfl`` / ``cwfl_prox`` — Algorithm 1's clustered two-phase OTA
  aggregation (`repro_torch.core.cwfl`); the prox variant runs the same
  channel with the FedProx local objective (µ_p = 0.1, paper §V).
* ``cotaf`` / ``cotaf_prox`` — the modified-COTAF central-server baseline:
  one shared MAC to the best-connected client
  (`repro_torch.core.baselines`).
* ``fedavg`` — ideal noiseless server aggregation (the upper bound).
* ``decentralized`` — Metropolis–Hastings consensus over G(V, L); absence
  is graph pruning, not MAC masking (isolated nodes keep their params).

CWFL, COTAF and decentralized report their internals through the
``telemetry`` hook (the prox variants inherit theirs); FedAvg reports the
default single global site.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.core import baselines
from repro_torch.core import channel as ch
from repro_torch.core import clustering as cl
from repro_torch.core import cwfl
from repro_torch.strategies.base import Strategy, register_strategy


@dataclasses.dataclass(frozen=True)
class CWFLStrategy(Strategy):
    """Algorithm 1: cluster on SNR, water-fill, two-phase OTA aggregation."""

    supports_client_sharding: ClassVar[bool] = True
    water_fills: ClassVar[bool] = True
    reclusters: ClassVar[bool] = True

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        return cwfl.setup(
            topology,
            cwfl.CWFLConfig(num_clusters=cfg.num_clusters, snr_db=snr_db),
            draws.kmeans_first(topology.num_clients))

    def state_from_view(self, state0, view, noise_var, *, csi=None,
                        mask=None, plan=None, alive=None):
        del mask, alive   # folded into the round coefficients by aggregate()
        return cwfl.state_from_plan(
            state0.plan if plan is None else plan, view.link_gain,
            state0.total_power, noise_var, csi_perturb=csi)

    def init_batch(self, topology, draws, cfg, trajectories):
        # A seed draws K-means' first centre once; its trajectories share
        # the plan and differ in their noise budget (`cwfl.setup`'s rule).
        # JAX traces a sweep's setup, so the heads are elected in XLA's
        # jitted order (a lone run's setup is eager: `init`); the
        # topology is a constant of JAX's trace, so XLA folds the features
        # at compile time.
        plans, states = {}, []
        for i, snr in trajectories:
            if i not in plans:
                plans[i] = cl.make_cluster_plan(
                    topology.link_snr, topology.adjacency, cfg.num_clusters,
                    draws[i].kmeans_first(topology.num_clients),
                    jitted=True, db_mode="folded")
            noise_var = (topology.noise_var if snr is None else
                         ch.snr_db_to_noise_var(topology.total_power, snr))
            states.append(cwfl.state_from_plan(
                plans[i], topology.link_gain, float(topology.total_power),
                noise_var))
        return cwfl.stack_states(states)

    def sync_noise(self, draws, round_, num_clients, num_clusters, d):
        return draws.phase_noise(round_, num_clusters, d)

    def aggregate(self, stacked_params, state, noise, mask=None,
                  alive=None):
        # A fault round (``alive`` given) runs the guarded kernel.
        return cwfl.aggregate(stacked_params, state, noise, mask=mask,
                              alive=alive)

    def aggregate_batch(self, stacked_params, state, noise, mask=None,
                        alive=None):
        return cwfl.aggregate_batch(stacked_params, state, noise, mask=mask,
                                    alive=alive)

    def receive_mask(self, state, mask, alive=None):
        # Heads are the phase-1/2 receivers: they keep the aggregate they
        # computed, unless they crashed.
        return cwfl.participation_weights(state, mask, alive=alive)

    def on_head_failure(self, state0, plan, view, alive):
        # Keep live heads; a dead head is replaced by the surviving member
        # with the best within-cluster aggregate link SNR.  Derived afresh
        # each round, so a recovered head resumes.
        return cl.reelect_heads(state0.plan if plan is None else plan,
                                view.link_snr, alive)

    def recluster(self, view, num_clusters: int, first: int):
        # JAX re-clusters inside its jitted round, loop and scan alike, so
        # the heads are elected in XLA's jitted order.
        return cl.make_cluster_plan(view.link_snr, view.adjacency,
                                    num_clusters, first, jitted=True)

    def channel_uses(self, num_clients, num_clusters=None,
                     participants=None):
        # Paper §IV: C OTA intra-cluster slots and C(C−1) directed
        # head→head uses, whoever shows up (heads are forced present).
        del num_clients, participants
        C = num_clusters
        return C * (C - 1) + C

    def telemetry(self, state, *, losses, stacked, new_stacked, consensus,
                  mask=None):
        from repro_torch.obs.telemetry import (per_client_dim,
                                               stacked_consensus_drift)

        plan = state.plan
        counts = torch.clamp(plan.membership.sum(dim=1), min=1.0)
        part = cwfl.participation_weights(state, mask)
        participants = (torch.full((), float(state.num_clients),
                                   dtype=torch.float32, device=losses.device)
                        if part is None else torch.sum(part))
        # The coefficients this round transmitted with: the eq. (5)
        # precode scales and the phase-1/2 equivalent receiver-noise stds.
        mean_sq = cwfl.per_client_mean_sq(stacked)
        _, eff_std1, _, kappa, _ = cwfl.round_coefficients(
            state, stacked, mask=mask, mean_sq=mean_sq)
        pre = cwfl.precode_scale(state, mean_sq)
        # Per-channel-use power each member puts on the MAC: amplitude² =
        # (p_k · pre_k)² per unit-power symbol, × E‖θ‖²/d.  Heads never
        # cross the channel (virtual clients).
        member = 1.0 - plan.head_mask
        amp2 = (state.client_power / state.total_power) * pre ** 2
        tx_power = member * amp2 * mean_sq
        if part is not None:
            tx_power = tx_power * part
        d = per_client_dim(stacked)
        return {
            "cluster_loss": (plan.membership @ losses) / counts,
            "participants": participants,
            "consensus_drift": stacked_consensus_drift(
                new_stacked, consensus)[plan.heads],
            "extras": {
                "precode_scale": pre,
                "client_power": state.client_power,
                "tx_power": tx_power,
                "power_budget_frac": torch.sum(tx_power) / state.total_power,
                "phase1_noise_std": eff_std1,
                "phase2_noise_std": kappa,
                "noise_energy": d * (torch.sum(eff_std1 ** 2)
                                     + torch.sum(kappa ** 2)),
            },
        }


def _mac_std(noise_std: torch.Tensor, total_power: float) -> torch.Tensor:
    """A receiver's noise std per unit of transmit power, σ/sqrt(P), with
    sqrt(P) in f32 as JAX's ``jnp.sqrt`` of a Python float."""
    return noise_std / torch.sqrt(cwfl.f32_scalar(total_power,
                                                  noise_std.device))


@dataclasses.dataclass(frozen=True)
class COTAFStrategy(Strategy):
    """Modified COTAF: all K clients on ONE MAC to a central server."""

    water_fills: ClassVar[bool] = True

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        del draws, cfg
        return baselines.cotaf_setup(topology, snr_db=snr_db)

    def state_from_view(self, state0, view, noise_var, *, csi=None,
                        mask=None, plan=None, alive=None):
        del mask, plan
        # Server failover: the pick runs over surviving nodes only.
        return baselines.cotaf_state_from_gains(
            view.link_gain, state0.total_power, noise_var, csi_perturb=csi,
            alive=alive)

    def sync_noise(self, draws, round_, num_clients, num_clusters, d):
        return draws.sync_noise(round_, 1, d)

    def aggregate(self, stacked_params, state, noise, mask=None,
                  alive=None):
        del alive   # failover happened in state_from_view; dead nodes
        # arrive masked off the MAC by the engine's transmit fold.
        return baselines.cotaf_aggregate(stacked_params, state, noise,
                                         mask=mask)

    def aggregate_batch(self, stacked_params, state, noise, mask=None,
                        alive=None):
        del alive   # as in aggregate()
        return baselines.cotaf_aggregate_batch(stacked_params, state, noise,
                                               mask=mask)

    def receive_mask(self, state, mask, alive=None):
        # The server holds the aggregate, so it keeps it; failover keeps
        # the server alive whenever any node is.
        del alive
        return baselines.cotaf_participation(state, mask)

    def channel_uses(self, num_clients, num_clusters=None,
                     participants=None):
        # One shared OTA MAC to the server, however many transmit on it.
        del num_clients, num_clusters, participants
        return 1

    def telemetry(self, state, *, losses, stacked, new_stacked, consensus,
                  mask=None):
        t = super().telemetry(state, losses=losses, stacked=stacked,
                              new_stacked=new_stacked, consensus=consensus,
                              mask=mask)
        part = baselines.cotaf_participation(state, mask)
        if part is not None:
            t["participants"] = torch.sum(part)
        # No server is decided by the state's structure, never by a read.
        t["extras"] = {
            "server": (torch.full((), -1.0, dtype=torch.float32,
                                  device=losses.device)
                       if state.server is None
                       else state.server.to(torch.float32)),
            "client_power": state.client_power,
            "mac_noise_std": _mac_std(state.noise_std, state.total_power),
        }
        return t


@dataclasses.dataclass(frozen=True)
class FedAvgStrategy(Strategy):
    """Ideal noiseless server aggregation (eq. 2); no state, no noise."""

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        del topology, draws, cfg, snr_db
        return None

    def state_from_view(self, state0, view, noise_var, *, csi=None,
                        mask=None, plan=None, alive=None):
        # Stateless: None, or a sweep's count of trajectories.
        del view, noise_var, csi, mask, plan, alive
        return state0

    def aggregate(self, stacked_params, state, noise, mask=None,
                  alive=None):
        del state, noise, alive   # dead nodes arrive masked
        return baselines.fedavg_aggregate(stacked_params, weights=mask)

    def init_batch(self, topology, draws, cfg, trajectories):
        # No state; the count of trajectories is all the sync needs.
        del topology, draws, cfg
        return len(trajectories)

    def aggregate_batch(self, stacked_params, state, noise, mask=None,
                        alive=None):
        del noise, alive   # dead nodes arrive masked
        return baselines.fedavg_aggregate_batch(stacked_params, state,
                                                weights=mask)


@dataclasses.dataclass(frozen=True)
class DecentralizedStrategy(Strategy):
    """Fully-decentralized Metropolis–Hastings consensus over G(V, L)."""

    needs_graph: ClassVar[bool] = True

    def init(self, topology, draws, cfg, snr_db: Optional[float] = None):
        del draws, cfg
        return baselines.decentralized_setup(topology, snr_db=snr_db)

    def state_from_view(self, state0, view, noise_var, *, csi=None,
                        mask=None, plan=None, alive=None):
        del csi, plan, alive   # dead nodes arrive masked
        # Absence is graph pruning: Metropolis weights give an isolated
        # (absent or crashed) node W(k,k) = 1, so it keeps its params with
        # no noise.
        adj = view.adjacency
        if mask is not None:
            mb = mask > 0
            adj = adj & mb[:, None] & mb[None, :]
        return baselines.decentralized_state_from_graph(
            adj, state0.total_power, noise_var)

    def sync_noise(self, draws, round_, num_clients, num_clusters, d):
        return draws.sync_noise(round_, num_clients, d)

    def aggregate(self, stacked_params, state, noise, mask=None,
                  alive=None):
        del mask, alive   # already pruned into the Metropolis graph
        return baselines.decentralized_aggregate(stacked_params, state,
                                                 noise)

    def aggregate_batch(self, stacked_params, state, noise, mask=None,
                        alive=None):
        del mask, alive   # already pruned into each Metropolis graph
        return baselines.decentralized_aggregate_batch(stacked_params,
                                                       state, noise)

    def receive_mask(self, state, mask, alive=None):
        # The mixing matrix holds the absences: no receive fold, and no
        # skip of a round nobody attended.
        del state, mask, alive
        return None

    def channel_uses(self, num_clients, num_clusters=None,
                     participants=None):
        # Eq. 3's full gossip: every participant transmits to every other.
        del num_clusters
        p = num_clients if participants is None else participants
        return p * (p - 1)

    def telemetry(self, state, *, losses, stacked, new_stacked, consensus,
                  mask=None):
        t = super().telemetry(state, losses=losses, stacked=stacked,
                              new_stacked=new_stacked, consensus=consensus,
                              mask=mask)
        W = state.mixing
        off = W * (1.0 - torch.eye(W.shape[0], device=W.device))
        t["extras"] = {
            "active_links": torch.sum(off > 0).to(torch.float32),
            "mean_self_weight": torch.mean(torch.diagonal(W)),
            "receive_noise_std": torch.sqrt(torch.sum(off ** 2, dim=1))
            * _mac_std(state.noise_std, state.total_power),
        }
        return t


#: Paper §V's FedProx coefficient for the *-Prox curves.
PAPER_MU_PROX = 0.1

register_strategy("cwfl", CWFLStrategy(name="cwfl"))
register_strategy("cotaf", COTAFStrategy(name="cotaf"))
register_strategy("fedavg", FedAvgStrategy(name="fedavg"))
register_strategy("decentralized", DecentralizedStrategy(name="decentralized"))
register_strategy("cwfl_prox",
                  CWFLStrategy(name="cwfl_prox", mu_prox=PAPER_MU_PROX))
register_strategy("cotaf_prox",
                  COTAFStrategy(name="cotaf_prox", mu_prox=PAPER_MU_PROX))
