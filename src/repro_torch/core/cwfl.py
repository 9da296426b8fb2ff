"""CWFL: the paper's 3-phase clustered over-the-air aggregation (Algorithm 1).

Port of `repro.core.cwfl`, flat path only.  Operates on K-stacked
parameter trees (every leaf has a leading client axis K) that are packed
once into a ``(K, d)`` f32 matrix and sent through the fused round
(`repro_torch.kernels.cwfl_round`):

  1. intra-cluster OTA MAC:  θ̃_c = Σ_{k∈K_c} p_k θ_k + θ_{v,c} + w̃_c   (eq. 8)
  2. inter-head consensus:   θ̄_c = Σ_j W(c,j)(θ̃_j + ṽ_j) + θ̃_c        (eq. 9 / lemma 2)
  3. broadcast:              θ_k ← θ̄_{c(k)}  (error-free downlink)

Each phase's weights are renormalized into a convex combination (the
literal equations have total weight > 1 and diverge when iterated), and
the phase-1 amplitudes carry eq. (5)'s norm-limiting precoding: the JAX
package's defaults, the only mode the port runs.  A scenario's
participation mask and a fault scenario's node-up vector fold into the
round coefficients (`round_coefficients`), and a fault round runs the
kernel's guarded variant.  A Monte-Carlo sweep's trajectories run their
rounds together (:func:`aggregate_batch`): states stacked along a
leading trajectory axis, their clients stacked beside K, one batched
launch of the round kernel a round, guarded in a fault round.  The
round's noise comes in as two ``(C, d)`` matrices of unit normals, which
this module scales by the phase-1 and phase-2 receiver stds — JAX draws
``std[:, None] * normal(key, ...)`` per leaf, so unit normals passed in
reproduce its noise exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import channel as ch
from repro_torch.core import clustering as cl
from repro_torch.core.topology import Topology
from repro_torch.kernels.cwfl_round import cwfl_round
from repro_torch.utils.nest import nest_vmap
from repro_torch.utils.pytree import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CWFLConfig:
    num_clusters: int = 3
    snr_db: Optional[float] = None  # override topology noise to hit overall SNR


@dataclasses.dataclass(frozen=True)
class CWFLState:
    """Everything the aggregation operator needs, precomputed offline."""

    plan: cl.ClusterPlan
    client_power: torch.Tensor        # (K,) water-filled P_k, Σ = P
    total_power: float                # P
    head_noise_std: torch.Tensor      # (C,) σ_c (receiver AWGN std, phase 1)
    consensus_noise_std: torch.Tensor  # (C,) σ on head→head links (phase 2)
    mix: torch.Tensor                 # (C, C) consensus weights W (diag = 0)

    @property
    def num_clients(self) -> int:
        return int(self.client_power.shape[-1])

    @property
    def num_clusters(self) -> int:
        return self.plan.num_clusters


def setup(topology: Topology, cfg: CWFLConfig, first: int) -> CWFLState:
    """Offline phase: cluster on SNR, water-fill power, build W (paper §IV).
    ``first`` is K-means' first centre (`clustering._kmeans`)."""
    plan = cl.make_cluster_plan(topology.link_snr, topology.adjacency,
                                cfg.num_clusters, first)
    noise_var = topology.noise_var
    if cfg.snr_db is not None:
        noise_var = ch.snr_db_to_noise_var(topology.total_power, cfg.snr_db)
    return state_from_plan(plan, topology.link_gain,
                           float(topology.total_power), noise_var)


def state_from_plan(plan: cl.ClusterPlan, link_gain: torch.Tensor,
                    total_power: float, noise_var: float,
                    csi_perturb: Optional[torch.Tensor] = None) -> CWFLState:
    """Water-fill power and budget noise for a given cluster plan (the
    engine rebuilds it every round of a dynamic scenario).

    ``csi_perturb``: optional (K,) factor on the effective water-filling
    gains — imperfect CSI at the power allocator (the true channel still
    carries the signal)."""
    K = link_gain.shape[0]
    dev = link_gain.device
    C = plan.num_clusters

    # Effective member→head channel gains; heads use their mean head→head gain.
    head_of = plan.heads[plan.assignment]                     # (K,)
    gain_to_head = torch.abs(link_gain[torch.arange(K, device=dev),
                                       head_of]) ** 2
    head_rows = torch.abs(link_gain[plan.heads][:, plan.heads]) ** 2
    mean_h2h = head_rows.sum() / max(C * (C - 1), 1)
    is_head = plan.head_mask > 0
    eff_gain = torch.where(is_head, mean_h2h, gain_to_head) / noise_var
    if csi_perturb is not None:
        eff_gain = eff_gain * csi_perturb

    client_power = ch.water_filling(eff_gain, total_power)
    sigma = torch.sqrt(f32_scalar(noise_var, dev))
    noise_std = torch.full((C,), 1.0, dtype=torch.float32, device=dev) * sigma
    return CWFLState(plan=plan, client_power=client_power,
                     total_power=total_power, head_noise_std=noise_std,
                     consensus_noise_std=noise_std.clone(),
                     mix=cl.consensus_weights(plan.cluster_snr))


def per_client_mean_sq(stacked) -> torch.Tensor:
    """(K,) per-channel-use signal power ‖θ_k‖²/d — eq. (5)'s estimator."""
    leaves, _ = tree_flatten(stacked)
    sq = sum(torch.sum(torch.square(x.to(torch.float32)).reshape(
        x.shape[0], -1), dim=1) for x in leaves)
    d = sum(x[0].numel() for x in leaves)
    return sq / max(d, 1)


def precode_scale(state: CWFLState, mean_sq_norm: torch.Tensor
                  ) -> torch.Tensor:
    """Eq. (5) amplitude scale per client, heads exempt (virtual clients
    whose local contribution never crosses the channel)."""
    pre = ch.precode_amplitude(state.client_power, mean_sq_norm)
    return torch.where(state.plan.head_mask > 0, 1.0, pre)


def f32_scalar(x, device) -> torch.Tensor:
    """A 0-d f32 tensor of ``x`` on ``device``: a Python number is filled
    in on the device (no copy from the host, so a captured round may make
    one), a tensor is cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _sqrt32(x: float, device) -> torch.Tensor:
    """sqrt of a Python float in f32, as ``jnp.sqrt(float)`` computes it."""
    return torch.sqrt(f32_scalar(x, device))


def phase1_weights(state: CWFLState) -> torch.Tensor:
    """(C, K) OTA weights: p_k = sqrt(P_k/P) for members, 1 for the head's
    virtual client (noiseless local contribution)."""
    p = torch.sqrt(state.client_power / state.total_power)
    w_k = torch.where(state.plan.head_mask > 0, 1.0, p)
    return state.plan.membership * w_k[None, :]


def phase2_weights(state: CWFLState,
                   live: Optional[torch.Tensor] = None):
    """(C, C) inter-head mix B = W + I and (C,) equivalent per-receiver
    noise std κ_c = sqrt(Σ_j W(c,j)²)·σ̃ (eq. 9 / lemma 2), both divided by
    the row sums of B.

    ``live``: optional (C,) bool cluster liveness (fault scenarios).  A
    dead cluster transmits nothing in phase 2, so its B column is zeroed
    before the row renormalization, whose row sums are then clamped at
    1e-12 (an all-dead plan leaves all-zero rows)."""
    dev = state.mix.device
    b = state.mix + torch.eye(state.num_clusters, device=dev)
    eff_std2 = (state.consensus_noise_std
                / _sqrt32(state.total_power, dev))
    mix = state.mix
    if live is not None:
        lv = live.to(torch.float32)
        b = b * lv[None, :]
        mix = mix * lv[None, :]
    kappa = torch.sqrt(torch.sum(mix ** 2, dim=1)) * eff_std2
    row_sums = b.sum(dim=1, keepdim=True)
    if live is not None:
        row_sums = torch.clamp(row_sums, min=1e-12)
    return b / row_sums, kappa / row_sums[:, 0]


def participation_weights(state: CWFLState, mask: Optional[torch.Tensor],
                          alive: Optional[torch.Tensor] = None
                          ) -> Optional[torch.Tensor]:
    """(K,) effective participation of one round, or ``None`` if neither a
    mask nor a node-up vector is given.

    Cluster-heads are forced present: they are the phase-1 receivers and
    the phase-2 endpoints, so a mask entry of 0 on a head is ignored.  A
    crashed head (``alive`` 0, fault scenarios) is not forced present:
    the engine re-elects a surviving head first
    (`clustering.reelect_heads`)."""
    if mask is None and alive is None:
        return None
    forced = state.plan.head_mask
    if alive is not None:
        forced = forced * alive.to(torch.float32)
    m = (torch.ones_like(forced) if mask is None
         else mask.to(torch.float32))
    return torch.where(forced > 0, 1.0, m)


def round_coefficients(state: CWFLState, stacked_params=None,
                       mask: Optional[torch.Tensor] = None,
                       alive: Optional[torch.Tensor] = None,
                       mean_sq: Optional[torch.Tensor] = None):
    """The weight set of one sync round: ``(Ã, eff_std1, B̃, κ, M)`` — the
    precoded, renormalized phase-1 amplitudes with their receiver noise
    std, the consensus mix with its equivalent noise std, and the phase-3
    downlink matrix.  The eq. (5) amplitude clip is estimated from the
    transmitted signals' power: ``stacked_params`` (any K-stacked tree, a
    flat (K, d) matrix included), or ``mean_sq``, the (K,) per-channel-use
    powers, for a caller that does not hold every client (a client-sharded
    rank, `repro_torch.sim.sharded`, gathers them).

    ``mask``: optional (K,) {0,1} participation; an absent client gets a
    zero column in Ã before the row renormalization, so each head's sum is
    a convex combination of the present members and its noise is
    renormalized by the same (smaller) row sum.
    ``alive``: optional (K,) {0,1} node-up vector (fault scenarios).  A
    cluster with no present transmit mass is dead: its Ã row and its
    phase-1 noise std are zeroed, and its column leaves B̃
    (`phase2_weights`)."""
    A = phase1_weights(state)
    part = participation_weights(state, mask, alive=alive)
    if part is not None:
        A = A * part[None, :]
    if mean_sq is None:
        if stacked_params is None:
            raise ValueError("round_coefficients needs stacked_params or "
                             "mean_sq: the eq. (5) amplitude clip is "
                             "estimated from the transmitted signals' power")
        mean_sq = per_client_mean_sq(stacked_params)
    A = A * precode_scale(state, mean_sq)[None, :]

    # Receiver scaling (eq. 8): AWGN std σ_c/sqrt(P); weights and noise are
    # both divided by the phase-1 row sums.
    eff_std1 = state.head_noise_std / _sqrt32(state.total_power, A.device)
    raw = A.sum(dim=1, keepdim=True)
    rows = torch.clamp(raw, min=1e-12)
    A = A / rows
    eff_std1 = eff_std1 / rows[:, 0]
    if alive is None:
        B, kappa = phase2_weights(state)
        return A, eff_std1, B, kappa, state.plan.membership.T
    dead = raw[:, 0] <= 0.0
    A = torch.where(dead[:, None], 0.0, A)
    eff_std1 = torch.where(dead, 0.0, eff_std1)
    B, kappa = phase2_weights(state, live=~dead)
    return A, eff_std1, B, kappa, state.plan.membership.T


def _flat_pack(leaves, rows: int) -> torch.Tensor:
    """K-stacked leaves -> one f32 ``(rows, d)`` matrix (leaf order)."""
    return torch.cat([x.reshape(rows, -1).to(torch.float32) for x in leaves],
                     dim=1)


def _flat_unpack(new_flat: torch.Tensor, cons_flat: torch.Tensor,
                 leaves, treedef, rows: int):
    """Inverse of :func:`_flat_pack` for the round's two outputs."""
    new_leaves, cons_leaves, off = [], [], 0
    lead = cons_flat.shape[:-1]   # (B,) for B stacked trajectories
    for x in leaves:
        n = math.prod(x.shape[1:])
        new_leaves.append(new_flat[:, off:off + n].reshape(x.shape)
                          .to(x.dtype))
        cons_leaves.append(cons_flat[..., off:off + n]
                           .reshape(lead + x.shape[1:]).to(x.dtype))
        off += n
    return (tree_unflatten(treedef, new_leaves),
            tree_unflatten(treedef, cons_leaves))


def _aggregate_flat(stacked_params, state: CWFLState, noise,
                    mask=None, alive=None):
    """One (K, d) matrix through the fused round kernel."""
    leaves, treedef = tree_flatten(stacked_params)
    K = leaves[0].shape[0]
    A, eff_std1, B, kappa, m_back = round_coefficients(
        state, stacked_params, mask=mask, alive=alive)
    unit1, unit2 = noise
    flat = _flat_pack(leaves, K)
    new_flat, cons_flat = cwfl_round(flat, A, eff_std1[:, None] * unit1, B,
                                     kappa[:, None] * unit2, m_back,
                                     guard=alive is not None)
    return _flat_unpack(new_flat, cons_flat, leaves, treedef, K)


def aggregate(stacked_params, state: CWFLState, noise,
              mask: Optional[torch.Tensor] = None,
              alive: Optional[torch.Tensor] = None):
    """One CWFL sync round.  Returns ``(new_stacked_params, consensus)``.

    ``stacked_params``: parameter tree, every leaf (K, ...) f32.
    ``noise``: ``(unit1, unit2)``, two (C, d) f32 matrices of unit normals
      for phase 1 and phase 2, columns in the flat leaf order.
    ``mask``, ``alive``: the round's participation and node-up vectors,
      folded into the coefficients (`round_coefficients`); the transmit
      side only.  A round given ``alive`` (a fault round) runs the
      kernel's guarded variant: non-finite signals count as 0, so a
      quarantined client's poisoned update cannot reach the MAC sum, and
      dead Ã rows are zeroed with their noise.
    """
    for x in tree_flatten(stacked_params)[0]:
        if x.dtype != torch.float32:
            raise TypeError(f"the flat round takes f32 leaves, got {x.dtype}")
    return _aggregate_flat(stacked_params, state, noise, mask=mask,
                           alive=alive)


def stack_states(states: Sequence):
    """States of B trajectories (dataclasses of one kind, such as
    `CWFLState`) as one of the same kind, every tensor stacked along a new
    leading trajectory axis; nested dataclasses likewise; other fields
    (the total power) must agree and are kept."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(states))
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_states([getattr(x, f.name) for x in states])
            for f in dataclasses.fields(first)})
    if any(x != first for x in states):
        raise ValueError(f"trajectories disagree on a shared field: "
                         f"{[x for x in states]}")
    return first


def round_coefficients_batch(state: CWFLState, stacked_params,
                             mask: Optional[torch.Tensor] = None,
                             alive: Optional[torch.Tensor] = None):
    """:func:`round_coefficients` of B trajectories at once: ``state`` is
    B states stacked (:func:`stack_states`), ``stacked_params`` a tree of
    (B·K, ...) leaves, trajectory b's clients at rows b·K .. b·K + K − 1,
    ``mask`` and ``alive`` (B, K) or ``None``.  The O(C·K) arithmetic
    runs under ``torch.func.vmap``, each trajectory's precoding estimated
    from its own clients' powers leaf by leaf, as :func:`round_coefficients`
    does.  Returns the five of :func:`round_coefficients` with a leading
    B: (B, C, K), (B, C), (B, C, C), (B, C), (B, K, C)."""
    leaves, treedef = tree_flatten(stacked_params)
    B = state.client_power.shape[0]
    by_traj = [x.reshape((B, -1) + x.shape[1:]) for x in leaves]
    return nest_vmap(
        lambda st, params, m, a: round_coefficients(
            st, tree_unflatten(treedef, params), mask=m, alive=a),
        state, by_traj, mask, alive)


def aggregate_batch(stacked_params, state: CWFLState, noise,
                    mask: Optional[torch.Tensor] = None,
                    alive: Optional[torch.Tensor] = None):
    """One CWFL sync of B stacked trajectories in one launch of the round
    kernel.  Returns ``(new_stacked, consensus)``: the tree of (B·K, ...)
    leaves and the B consensus trees, leaves (B, ...).

    ``stacked_params``: leaves (B·K, ...) f32, trajectory b's clients at
      rows b·K .. b·K + K − 1.
    ``state``: the B trajectories' states stacked (:func:`stack_states`):
      each its own plan (its seed drew K-means' first centre) and noise
      std (its SNR).
    ``noise``: ``(unit1, unit2)``, two (B, C, d) unit-normal matrices.
    ``mask``, ``alive``: (B, K), as :func:`aggregate`'s for each
      trajectory; a batch given ``alive`` runs the guarded kernel.
    """
    leaves, treedef = tree_flatten(stacked_params)
    for x in leaves:
        if x.dtype != torch.float32:
            raise TypeError(f"the flat round takes f32 leaves, got {x.dtype}")
    BK = leaves[0].shape[0]
    B = state.client_power.shape[0]
    A, eff_std1, Bmix, kappa, m_back = round_coefficients_batch(
        state, stacked_params, mask=mask, alive=alive)
    unit1, unit2 = noise
    flat = _flat_pack(leaves, BK)
    new_flat, cons_flat = cwfl_round(
        flat.view(B, BK // B, -1), A, eff_std1[..., None] * unit1, Bmix,
        kappa[..., None] * unit2, m_back, guard=alive is not None)
    return _flat_unpack(new_flat.view(BK, -1), cons_flat, leaves, treedef,
                        BK)


def channel_uses_per_round(num_clients: int, num_clusters: int) -> dict:
    """The paper's §IV efficiency comparison for one (K, C) point: CWFL's
    C(C−1) consensus uses + C OTA slots, vs K(K−1) for fully-decentralized
    consensus, vs 1 for a single-server OTA MAC."""
    C, K = num_clusters, num_clients
    return {"cwfl": C * (C - 1) + C, "decentralized": K * (K - 1),
            "server_ota": 1}
