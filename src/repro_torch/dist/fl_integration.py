"""CWFL ⇄ production-training integration: the offline FL plan and the
paper-faithful hierarchical OTA collective (port of
`repro.dist.fl_integration`).

Shard mode: one model copy; clients are groups of examples in the global
batch.  Per-example losses enter the total loss linearly, so the gradient
of the β-weighted mean loss equals the β-weighted consensus of per-client
gradients: Algorithm 1 reduces to per-example loss weights
(`FLPlan.example_weights`) and a post-backward channel-noise injection
(`add_channel_noise`) whose std is the consensus-noise budget.

Replica mode: `hierarchical_ota_allreduce` runs the two OTA phases as a
``torch.distributed`` collective, one client a rank — phase 1 an
amplitude-weighted ``all_reduce`` (the superposition over clients IS the
sum), phase 2 the inter-head consensus mix — and returns the
receiver-independent consensus mean on every rank.

Noise comes in as unit normals (the port's draw seam), so a test can hand
both packages the same channel realization.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cwfl
from repro_torch.core.cwfl import CWFLState
from repro_torch.core.topology import Topology, TopologyConfig, make_topology
from repro_torch.sim.draws import Draws, TorchDraws
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_add_noise


@dataclasses.dataclass(frozen=True)
class FLPlan:
    """Everything the training step needs from the offline FL phase.

    ``beta`` is the water-filling-derived client distribution (Σβ = 1):
    the effective weight of client k's signal in the collective's
    consensus, β_k = Σ_c colmean(B)_c · Ã_{c,k}, Ã the row-normalized
    phase-1 amplitudes and B the normalized consensus mix.  ``noise_std``
    is the std of the consensus-mean channel noise per sync (the Q₂ term
    of Theorem 1); ``phase1_rel_std`` / ``phase2_rel_std`` are the
    per-cluster per-phase noise stds per unit ``noise_std``, so rescaling
    ``noise_std`` rescales the whole collective.  The arrays are numpy
    (float64 where JAX's are); ``state`` holds tensors on the plan's
    device.
    """

    num_clients: int
    num_clusters: int
    beta: np.ndarray              # (K,) water-filled client weights, Σ = 1
    assignment: np.ndarray        # (K,) cluster id per client
    heads: np.ndarray             # (C,) head client index per cluster
    mix: np.ndarray               # (C, C) inter-head weights W (diag = 0)
    cluster_weights: np.ndarray   # (C, C) row-normalized (W + I)
    noise_std: float              # consensus-mean channel noise std
    phase1_rel_std: np.ndarray    # (C,) θ̃ noise std / noise_std
    phase2_rel_std: np.ndarray    # (C,) head-exchange noise std / noise_std
    snr_db: float
    state: CWFLState              # full Algorithm-1 state (replica mode)

    def client_of_example(self, n: int) -> np.ndarray:
        """(n,) client id per example: contiguous, balanced blocks."""
        return (np.arange(n) * self.num_clients) // n

    def example_weights(self, n: int) -> np.ndarray:
        """(n,) loss weights with mean 1: the gradient of
        mean(w · per-example loss) equals Σ_k β_k ∇ mean_k(loss).

        A batch smaller than the client count renormalizes β over the
        clients present; if every present client has zero β the weights
        fall back to uniform rather than zeroing the gradient."""
        c = self.client_of_example(n)
        counts = np.bincount(c, minlength=self.num_clients)
        beta = self.beta
        if n < self.num_clients:
            present = counts > 0
            mass = beta[present].sum()
            if mass <= 0.0:
                return np.ones((n,), beta.dtype)
            beta = beta * present / mass
        return n * beta[c] / counts[c]


def make_fl_plan(num_clients: int, num_clusters: int, seed: int = 0,
                 snr_db: float = 40.0, *, topology: Optional[Topology] = None,
                 draws: Optional[Draws] = None, device=None) -> FLPlan:
    """Offline phase: draw a topology, cluster on SNR, water-fill power,
    and budget the consensus noise of the online collective.

    ``topology`` (default: drawn from ``seed`` with one hotspot a cluster)
    and ``draws`` (default: `TorchDraws` seeded with ``seed``; it gives
    K-means' first centre) let a caller replay another run's.
    ``device=None`` is the GPU."""
    device = resolve_device(device)
    K = num_clients
    if topology is None:
        topology = make_topology(seed, TopologyConfig(
            num_clients=K, num_hotspots=max(min(num_clusters, K), 1)),
            device=device)
    topology = topology.to(device)
    draws = draws if draws is not None else TorchDraws(seed, device)
    first = draws.kmeans_first(K)
    # K-means may leave clusters empty for small K (all clients at one
    # hotspot); an empty cluster has a zero phase-1 row whose receiver
    # renormalization explodes the noise budget.  Retry with the achieved
    # number of non-empty clusters until every cluster has members.
    c_req = max(min(num_clusters, K), 1)
    while True:
        state = cwfl.setup(topology, cwfl.CWFLConfig(num_clusters=c_req,
                                                     snr_db=snr_db), first)
        sizes = np.bincount(state.plan.assignment.cpu().numpy(),
                            minlength=c_req)
        if c_req == 1 or (sizes > 0).all():
            break
        c_req = max(int((sizes > 0).sum()), 1)

    # Phase-1 effective noise after receiver scaling and row normalization
    # (as cwfl.round_coefficients), from the state's receiver stds.
    A = cwfl.phase1_weights(state).cpu().numpy().astype(np.float64)
    row_a = np.maximum(A.sum(axis=1), 1e-12)
    a_norm = A / row_a[:, None]
    s1 = (state.head_noise_std.cpu().numpy().astype(np.float64)
          / np.sqrt(state.total_power) / row_a)                    # (C,)
    b_norm_t, s2_t = cwfl.phase2_weights(state)
    b_norm = b_norm_t.cpu().numpy().astype(np.float64)
    s2 = s2_t.cpu().numpy().astype(np.float64)                     # (C,)
    C = b_norm.shape[0]

    # The collective's effective per-client consensus weight.
    col_mean = b_norm.mean(axis=0)
    beta = col_mean @ a_norm
    beta = beta / max(beta.sum(), 1e-12)

    # Std of the consensus mean: cluster j's phase-1 noise reaches it with
    # coefficient colmean(b_norm)_j; the phase-2 noise averages 1/C.
    var = float((col_mean ** 2 * s1 ** 2).sum() + (s2 ** 2).sum() / C ** 2)
    noise_std = float(np.sqrt(var))
    denom = max(noise_std, 1e-30)
    return FLPlan(
        num_clients=K, num_clusters=C, beta=beta,
        assignment=state.plan.assignment.cpu().numpy(),
        heads=state.plan.heads.cpu().numpy(),
        mix=state.mix.cpu().numpy(), cluster_weights=b_norm,
        noise_std=noise_std, phase1_rel_std=s1 / denom,
        phase2_rel_std=s2 / denom, snr_db=float(snr_db), state=state)


def add_channel_noise(grads, noise, noise_std):
    """Post-backward channel-noise injection (shard mode).  ``noise``: one
    unit-normal tensor a leaf, or a ``torch.Generator``
    (`repro_torch.utils.pytree.tree_add_noise`).  A zero Python std is a
    no-op that draws nothing."""
    if isinstance(noise_std, (int, float)) and noise_std <= 0.0:
        return grads
    return tree_add_noise(grads, noise_std, noise)


def _check_world(plan: FLPlan, group) -> int:
    """The group's size, which must be the plan's client count: each rank
    reads its own column of the phase-1 weights."""
    world = dist.get_world_size(group)
    if world != plan.num_clients:
        raise ValueError(
            f"plan has {plan.num_clients} clients but the process group "
            f"has {world} ranks; one client per rank")
    return world


def hierarchical_ota_allreduce(x: torch.Tensor, plan: FLPlan, noise,
                               group=None) -> torch.Tensor:
    """The paper-faithful two-phase collective over a ``torch.distributed``
    group, one client a rank (the group's size must be
    ``plan.num_clients``); ``x`` is this rank's value (any shape).

    ``noise``: ``(unit1, unit2)``, each (C,) + x.shape f32 unit normals,
    the same on every rank (shared channel realization), so every rank
    returns the same bits.

    Phase 1 (eq. 8): every head receives the superposition of its
    members' amplitude-weighted signals — an ``all_reduce`` of
    ``col_k · x`` with the row-normalized phase-1 weights — plus receiver
    noise.  Phase 2 (eq. 9 / lemma 2): the heads mix with the
    row-normalized SNR weights, plus per-link noise.  Phase 3: the
    error-free broadcast of the consensus mean, returned in x's dtype.
    """
    _check_world(plan, group)
    dev = x.device
    a = cwfl.phase1_weights(plan.state).to(device=dev, dtype=torch.float32)
    a = a / torch.clamp(a.sum(dim=1, keepdim=True), min=1e-12)
    b_norm = torch.as_tensor(plan.cluster_weights, dtype=torch.float32,
                             device=dev)
    shape = (a.shape[0],) + (1,) * x.ndim
    col = a[:, dist.get_rank(group)]                              # (C,)
    unit1, unit2 = noise

    # Phase 1: the OTA MAC — the superposition over clients IS the sum.
    theta_tilde = col.reshape(shape) * x.to(torch.float32)[None]
    dist.all_reduce(theta_tilde, op=dist.ReduceOp.SUM, group=group)
    std1 = plan.noise_std * torch.as_tensor(
        plan.phase1_rel_std, dtype=torch.float32, device=dev)
    theta_tilde = theta_tilde + std1.reshape(shape) * unit1

    # Phase 2: inter-head consensus mix + equivalent per-receiver noise.
    theta_bar = torch.tensordot(b_norm, theta_tilde, dims=1)
    std2 = plan.noise_std * torch.as_tensor(
        plan.phase2_rel_std, dtype=torch.float32, device=dev)
    theta_bar = theta_bar + std2.reshape(shape) * unit2

    # Phase 3: error-free broadcast of the consensus mean.
    return torch.mean(theta_bar, dim=0).to(x.dtype)
