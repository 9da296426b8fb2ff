"""The baselines the paper compares CWFL against (§II, §V).

Port of `repro.core.baselines`:

* ``fedavg``        — ideal noiseless server aggregation (eq. 2), the
                      upper bound.
* ``cotaf``         — the paper's modified COTAF [5]: all K clients send
                      their raw parameters over ONE noisy MAC to a server,
                      with water-filled power.
* ``decentralized`` — consensus over G(V, L) (eq. 3) with Metropolis–
                      Hastings mixing; K(K−1) channel uses a round and
                      receiver noise on every link.

FedProx is a change of the local objective, not of the sync
(`repro_torch.training.local.fedprox_wrap`); ``cwfl_prox`` and
``cotaf_prox`` are registered strategies (`repro_torch.strategies`).

Every sync here is one product y = W·S + N on the flat ``(K, d)`` matrix
of the K-stacked parameters, one launch of the ``ota_aggregate`` kernel
(`repro_torch.kernels.ota_aggregate`), which reads S once for all rows of
W: one row for FedAvg and COTAF, K rows for decentralized.  The noise
comes in as unit normals in the flat leaf order, scaled here by each
row's receiver std — JAX draws
``std[:, None] * normal(key, ...)`` per leaf, so unit normals passed in
reproduce its noise exactly.

A Monte-Carlo sweep's trajectories sync together (the ``*_batch``
functions): their clients stacked beside K, their states stacked along a
leading trajectory axis (`repro_torch.core.cwfl.stack_states`), the
weights computed under ``torch.func.vmap`` (a dynamic scenario's masks
included), and one batched launch of the kernel a round for all of
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import channel as ch
from repro_torch.core.cwfl import (_flat_pack, _flat_unpack, _sqrt32,
                                   f32_scalar, per_client_mean_sq)
from repro_torch.core.topology import Topology
from repro_torch.kernels.ota_aggregate import ota_aggregate
from repro_torch.utils.nest import nest_vmap
from repro_torch.utils.pytree import tree_flatten, tree_unflatten


def _mix(stacked_params, weights: torch.Tensor, noise: torch.Tensor):
    """y = weights·S + noise on the flat (K, d) matrix S of
    ``stacked_params``, in one launch of the kernel whatever the number of
    rows.  One row of weights: every client gets y's row, which is the
    consensus.  K rows: client k gets row k, and the consensus is the mean
    of the rows in f32.  Returns ``(new_stacked, consensus)``."""
    leaves, treedef = tree_flatten(stacked_params)
    K = leaves[0].shape[0]
    y = ota_aggregate(_flat_pack(leaves, K), weights, noise)
    if y.shape[0] == 1:
        new_flat, cons_flat = y.expand(K, -1), y[0]
    else:
        new_flat, cons_flat = y, torch.mean(y, dim=0)
    return _flat_unpack(new_flat, cons_flat, leaves, treedef, K)


def _mix_batch(stacked_params, weights: torch.Tensor, noise: torch.Tensor):
    """:func:`_mix` of B stacked trajectories in one launch: leaves
    (B·K, ...), trajectory b's clients at rows b·K .. b·K + K − 1;
    ``weights`` (B, R, K), ``noise`` (B, R, d).  Returns the (B·K, ...)
    tree and the B consensus trees (leaves (B, ...))."""
    leaves, treedef = tree_flatten(stacked_params)
    BK = leaves[0].shape[0]
    B = weights.shape[0]
    K = BK // B
    flat = _flat_pack(leaves, BK).view(B, K, -1)
    y = ota_aggregate(flat, weights, noise)                       # (B, R, d)
    if y.shape[1] == 1:
        new_flat, cons_flat = y.expand(B, K, -1), y[:, 0]
    else:
        new_flat, cons_flat = y, torch.mean(y, dim=1)
    return _flat_unpack(new_flat.reshape(BK, -1), cons_flat, leaves,
                        treedef, BK)


def _by_trajectory(stacked_params, B: int):
    """``(treedef, leaves)`` with every (B·K, ...) leaf as (B, K, ...)."""
    leaves, treedef = tree_flatten(stacked_params)
    K = leaves[0].shape[0] // B
    return treedef, [x.reshape((B, K) + x.shape[1:]) for x in leaves]


# ---------------------------------------------------------------------------
# FedAvg (ideal, noiseless).
# ---------------------------------------------------------------------------

def fedavg_aggregate(stacked_params, weights: Optional[torch.Tensor] = None):
    """θ ← Σ_k p_k θ_k with Σ p_k = 1 (eq. 2); returns (stacked, consensus).
    ``weights``: optional (K,) p_k, normalized here (a round's mask: an
    all-zero mask gives 0/0, NaN weights, which the engine's receive fold
    discards)."""
    leaves, _ = tree_flatten(stacked_params)
    K, d = leaves[0].shape[0], sum(x[0].numel() for x in leaves)
    dev = leaves[0].device
    if weights is None:
        weights = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    weights = weights.to(torch.float32)
    weights = weights / weights.sum()
    return _mix(stacked_params, weights[None, :],
                torch.zeros((1, d), dtype=torch.float32, device=dev))


def fedavg_aggregate_batch(stacked_params, num_trajectories: int,
                           weights: Optional[torch.Tensor] = None):
    """:func:`fedavg_aggregate` of B stacked trajectories in one launch;
    ``weights``: (B, K), each row normalized here, or ``None`` (equal
    weights).  See :func:`_mix_batch`."""
    leaves, _ = tree_flatten(stacked_params)
    B = num_trajectories
    K, d = leaves[0].shape[0] // B, sum(x[0].numel() for x in leaves)
    dev = leaves[0].device
    if weights is None:
        weights = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
        weights = (weights / weights.sum()).expand(B, K)
    else:
        weights = weights.to(torch.float32)
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return _mix_batch(stacked_params, weights[:, None, :],
                      torch.zeros((B, 1, d), dtype=torch.float32,
                                  device=dev))


# ---------------------------------------------------------------------------
# COTAF-modified: one server, one OTA MAC.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class COTAFState:
    client_power: torch.Tensor            # (K,) water-filled P_k
    total_power: float
    noise_std: torch.Tensor               # scalar σ at the server
    server: Optional[torch.Tensor] = None  # receiver index (None = unknown)


def cotaf_participation(state: COTAFState, mask: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
    """(K,) participation of one COTAF round, or ``None`` without a mask.
    The server is forced present: it is the MAC's receiver and its own data
    never crosses the channel.  A state without a server keeps the raw
    mask."""
    if mask is None:
        return None
    m = mask.to(torch.float32)
    if state.server is None:
        return m
    K = m.shape[0]
    return torch.where(torch.arange(K, device=m.device) == state.server,
                       1.0, m)


def cotaf_state_from_gains(link_gain: torch.Tensor, total_power: float,
                           noise_var, server=None,
                           csi_perturb: Optional[torch.Tensor] = None,
                           alive: Optional[torch.Tensor] = None
                           ) -> COTAFState:
    """COTAF's state from a (K, K) complex gain matrix (the engine rebuilds
    it every round of a dynamic scenario).

    The server is the client with the largest mean link gain
    ``mean_j |h_{k,j}|²`` (the first of equal ones), unless ``server``
    pins it.  ``alive``: optional (K,) node-up vector — the server fails
    over to the best live node; with every node down the unmasked choice
    stands.  ``csi_perturb``: optional (K,) factor on the water-filling
    gains (imperfect CSI)."""
    dev = link_gain.device
    if server is None:
        mean_gain = torch.mean(torch.abs(link_gain) ** 2, dim=1)
        server = torch.argmax(mean_gain)
        if alive is not None:
            up = alive > 0
            masked = torch.where(up, mean_gain, -torch.inf)
            server = torch.where(torch.any(up), torch.argmax(masked), server)
    s = torch.as_tensor(server, dtype=torch.int64, device=dev)
    # A 1-element index tensor, not a 0-d one: indexing by a 0-d tensor
    # reads it on the host, which a captured round cannot.
    g = torch.abs(link_gain[:, s.reshape(1)][:, 0]) ** 2 / noise_var
    # The server's own data arrives locally.
    g = torch.where(torch.arange(g.shape[0], device=dev) == s, torch.max(g), g)
    if csi_perturb is not None:
        g = g * csi_perturb
    return COTAFState(client_power=ch.water_filling(g, total_power),
                      total_power=total_power,
                      noise_std=torch.sqrt(f32_scalar(noise_var, dev)),
                      server=s)


def cotaf_setup(topology: Topology, snr_db: Optional[float] = None,
                server: Optional[int] = None) -> COTAFState:
    """Water-fill power over the client→server links of ``topology``
    (:func:`cotaf_state_from_gains` picks the server); ``snr_db``
    overrides the topology's noise budget."""
    noise_var = topology.noise_var
    if snr_db is not None:
        noise_var = ch.snr_db_to_noise_var(topology.total_power, snr_db)
    return cotaf_state_from_gains(topology.link_gain,
                                  float(topology.total_power), noise_var,
                                  server=server)


def cotaf_aggregate(stacked_params, state: COTAFState, noise: torch.Tensor,
                    normalize: bool = True, precode: bool = True,
                    mask: Optional[torch.Tensor] = None):
    """θ̃ = Σ_k sqrt(P_k/P) θ_k + w̃ over ONE shared MAC, broadcast to all
    K clients.  ``noise``: (1, d) unit normals.  ``normalize`` divides the
    amplitudes and the noise by the amplitudes' sum (a convex
    combination); ``precode`` applies eq. (5)'s amplitude clip on the
    per-channel-use mean square; ``mask``: optional (K,) participation —
    an absent client transmits nothing (the server is forced present,
    :func:`cotaf_participation`)."""
    A, eff_std = _cotaf_weights(stacked_params, state, normalize, precode,
                                mask)
    return _mix(stacked_params, A, eff_std[:, None] * noise)


def cotaf_aggregate_batch(stacked_params, state: COTAFState,
                          noise: torch.Tensor,
                          mask: Optional[torch.Tensor] = None):
    """:func:`cotaf_aggregate` (normalized, precoded) of B stacked
    trajectories in one launch: ``state`` B states stacked
    (`repro_torch.core.cwfl.stack_states`), ``noise`` (B, 1, d) unit
    normals, ``mask`` (B, K) or ``None``; the weights under
    ``torch.func.vmap``, each trajectory's precoding from its own
    clients.  See :func:`_mix_batch`."""
    B = state.client_power.shape[0]
    treedef, by_traj = _by_trajectory(stacked_params, B)
    A, eff_std = nest_vmap(
        lambda st, params, m: _cotaf_weights(tree_unflatten(treedef, params),
                                             st, True, True, m),
        state, by_traj, mask)
    return _mix_batch(stacked_params, A, eff_std[..., None] * noise)


def _cotaf_weights(stacked_params, state: COTAFState, normalize: bool,
                   precode: bool, mask: Optional[torch.Tensor]):
    """COTAF's (1, K) MAC weights and (1,) receiver noise std."""
    p = torch.sqrt(state.client_power / state.total_power)        # (K,)
    part = cotaf_participation(state, mask)
    if part is not None:
        p = p * part
    if precode:
        p = p * ch.precode_amplitude(state.client_power,
                                     per_client_mean_sq(stacked_params))
    A = p[None, :]                                                # (1, K)
    eff_std = (state.noise_std / _sqrt32(state.total_power, A.device))[None]
    if normalize:
        rows = torch.clamp(A.sum(dim=1, keepdim=True), min=1e-12)
        A, eff_std = A / rows, eff_std / rows[:, 0]
    return A, eff_std


# ---------------------------------------------------------------------------
# Fully-decentralized consensus (eq. 3).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecentralizedState:
    mixing: torch.Tensor       # (K, K) symmetric doubly-stochastic W̃
    noise_std: torch.Tensor    # scalar per-link receiver noise σ
    total_power: float


def metropolis_weights(adjacency: torch.Tensor) -> torch.Tensor:
    """Symmetric doubly-stochastic mixing from a graph (Metropolis–
    Hastings): W(i,j) = 1/(1+max(d_i, d_j)) on edges, diagonal
    1 − Σ_j W(i,j)."""
    K = adjacency.shape[0]
    eye = torch.eye(K, device=adjacency.device)
    adj = adjacency.to(torch.float32) * (1.0 - eye)
    deg = adj.sum(dim=1)
    W = adj / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return W + torch.diag(1.0 - W.sum(dim=1))


def decentralized_state_from_graph(adjacency: torch.Tensor,
                                   total_power: float,
                                   noise_var) -> DecentralizedState:
    """Decentralized state from an adjacency (the engine rebuilds it every
    round of a dynamic scenario, from the graph pruned of absent nodes).
    An isolated node gets W(k,k) = 1 and no noise: it keeps its
    parameters."""
    return DecentralizedState(
        mixing=metropolis_weights(adjacency),
        noise_std=torch.sqrt(f32_scalar(noise_var, adjacency.device)),
        total_power=total_power)


def decentralized_setup(topology: Topology, snr_db: Optional[float] = None
                        ) -> DecentralizedState:
    noise_var = topology.noise_var
    if snr_db is not None:
        noise_var = ch.snr_db_to_noise_var(topology.total_power, snr_db)
    return decentralized_state_from_graph(
        topology.adjacency, float(topology.total_power), noise_var)


def decentralized_aggregate(stacked_params, state: DecentralizedState,
                            noise: torch.Tensor):
    """θ_k ← Σ_j W̃(k,j) θ_j + receive noise; ``noise``: (K, d) unit
    normals.  The effective noise at node k, Σ_{j≠k} W̃(k,j) ṽ_j with
    ṽ ~ N(0, σ²/P), has std sqrt(Σ_{j≠k} W̃(k,j)²)·σ/√P (lemma 2's
    equivalent model).  The consensus is the mean of the K mixed rows."""
    W = state.mixing
    return _mix(stacked_params, W, _decentralized_std(state)[:, None] * noise)


def _decentralized_std(state: DecentralizedState) -> torch.Tensor:
    """(K,) effective receive-noise std of each node's mix."""
    W = state.mixing
    off = W * (1.0 - torch.eye(W.shape[0], device=W.device))
    return torch.sqrt(torch.sum(off ** 2, dim=1)) * (
        state.noise_std / _sqrt32(state.total_power, W.device))


def decentralized_aggregate_batch(stacked_params, state: DecentralizedState,
                                  noise: torch.Tensor):
    """:func:`decentralized_aggregate` of B stacked trajectories in one
    launch (K rows of weights each): ``state`` B states stacked,
    ``noise`` (B, K, d) unit normals.  See :func:`_mix_batch`."""
    eff_std = nest_vmap(_decentralized_std, state)
    return _mix_batch(stacked_params, state.mixing,
                      eff_std[..., None] * noise)
