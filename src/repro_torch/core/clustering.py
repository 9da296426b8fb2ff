"""SNR-aware, data-agnostic client clustering (paper §IV).

Port of `repro.core.clustering`.  Each client's feature is its link-SNR
profile (dB, outage links floored); K-means groups clients, and the member
nearest each centroid becomes its cluster-head.  ``argmin``/``argmax``
return the first occurrence, as JAX's do.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.xla_math import _fma_f32, db10


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Output of the offline clustering phase."""

    assignment: torch.Tensor       # (K,) int64 cluster id per client
    heads: torch.Tensor            # (C,) int64 client index of each head
    membership: torch.Tensor       # (C, K) f32 {0,1}; membership[c, k]
    cluster_snr: torch.Tensor      # (C,) ξ_c: mean member→head link SNR
    head_mask: torch.Tensor        # (K,) f32 {0,1} is-a-head indicator

    @property
    def num_clusters(self) -> int:
        return int(self.heads.shape[-1])


def _kmeans(features: torch.Tensor, num_clusters: int, first,
            iters: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd K-means with farthest-point initialization from the given
    first centre (JAX draws it with ``randint(key, (), 0, K)``; the caller
    draws it here, so the reference's pick can be passed in).  ``first``
    is a 0-d int64 tensor (or an int); the picks stay on the device, so a
    round that re-clusters never waits on the host."""
    C = num_clusters
    centers = torch.as_tensor(first, dtype=torch.int64,
                              device=features.device).reshape(1)
    for _ in range(1, C):
        d2 = torch.sum((features[:, None, :] - features[centers][None]) ** 2,
                       dim=-1)
        pick = torch.argmax(torch.min(d2, dim=1).values)
        centers = torch.cat([centers, pick.reshape(1)])
    centroids = features[centers]

    for _ in range(iters):
        d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
        onehot = F.one_hot(torch.argmin(d2, dim=1), C).to(features.dtype)
        counts = torch.clamp(onehot.sum(0), min=1.0)
        new = (onehot.T @ features) / counts[:, None]
        empty = (onehot.sum(0) == 0)[:, None]     # keep empty clusters put
        centroids = torch.where(empty, centroids, new)
    d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1), centroids


def _sum_in_xla_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, f32, in the order XLA's CPU reduction takes
    for a row of n terms.  Up to 32 terms: in index order.  Above, XLA
    rewrites the reduction as a reduce-window of 32 terms with stride 32
    over the row padded to a multiple of 32, the padding split evenly with
    the smaller half in front, each window summed in index order; then it
    reduces the ceil(n/32) window sums the same way.  Bitwise against
    ``jnp.sum`` at every n tested between 1 and 5,000
    (`tests/test_torch_offline.py::test_sum_in_xla_order_matches_xla`)."""
    n = x.shape[-1]
    if n <= 32:
        total = x[..., 0]
        for i in range(1, n):
            total = total + x[..., i]
        return total
    blocks = -(-n // 32)
    front = (32 * blocks - n) // 2
    sums = []
    for b in range(blocks):
        start, stop = max(32 * b - front, 0), min(32 * (b + 1) - front, n)
        sums.append(_sum_in_xla_order(x[..., start:stop]))
    return _sum_in_xla_order(torch.stack(sums, dim=-1))


def _sum_sq_in_xla_order(diff: torch.Tensor, jitted: bool) -> torch.Tensor:
    """Σ diff² over the last axis, f32, as XLA's CPU backend takes the
    election's ``jnp.sum(diff ** 2, axis=-1)``.  Eagerly the squares are
    rounded first and summed in `_sum_in_xla_order`.  Under ``jit`` a row
    of at most 32 terms is one fused loop that contracts each step into an
    FMA, acc = fma(dᵢ, dᵢ, acc) in index order from 0; above 32 terms XLA
    rewrites the sum as reduce-windows over the rounded squares, as
    eagerly."""
    if not jitted or diff.shape[-1] > 32:
        return _sum_in_xla_order(diff * diff)
    acc = torch.zeros(diff.shape[:-1], dtype=torch.float32,
                      device=diff.device)
    for i in range(diff.shape[-1]):
        acc = _fma_f32(diff[..., i], diff[..., i], acc)
    return acc


def snr_features(link_snr: torch.Tensor, adjacency: torch.Tensor,
                 floor_db: float = -30.0, db_mode: str = "eager"
                 ) -> torch.Tensor:
    """Per-client SNR profile features (dB, outage links floored), the dB
    taken as XLA takes it in JAX's context ``db_mode`` (`xla_math.db10`:
    ``"eager"``, ``"jit"`` or ``"folded"``)."""
    snr_db = db10(link_snr, db_mode)
    snr_db = torch.where(adjacency, snr_db, floor_db)
    return torch.clamp(snr_db, min=floor_db)


def make_cluster_plan(link_snr: torch.Tensor, adjacency: torch.Tensor,
                      num_clusters: int, first,
                      kmeans_iters: int = 50,
                      jitted: bool = False,
                      db_mode: str | None = None) -> ClusterPlan:
    """Full offline clustering: K-means on SNR features → heads → ξ_c.
    ``jitted``: elect the heads as JAX does under ``jit`` (its engine's
    re-clustering inside a run), else as its eager offline phase does.
    ``db_mode``: the context of the features' dB (`snr_features`); by
    default the election's, ``"jit"`` or ``"eager"``."""
    if db_mode is None:
        db_mode = "jit" if jitted else "eager"
    return _plan_from_features(snr_features(link_snr, adjacency,
                                            db_mode=db_mode), link_snr,
                               num_clusters, first, kmeans_iters, jitted)


def _plan_from_features(feats: torch.Tensor, link_snr: torch.Tensor,
                        num_clusters: int, first, kmeans_iters: int,
                        jitted: bool = False) -> ClusterPlan:
    """`make_cluster_plan` given the (K, K) features."""
    C = num_clusters
    assign, centroids = _kmeans(feats, C, first, kmeans_iters)
    clusters = torch.arange(C, device=link_snr.device)

    # Head of cluster c = member closest to centroid c (paper §IV): a plain
    # argmin, first occurrence, as JAX's.  A two-member cluster puts both
    # members at the same distance from its centroid in exact arithmetic,
    # so the f32 rounding of the sum of squares picks the head; the sum is
    # taken in the order XLA takes it on the CPU, eagerly or under jit
    # (`_sum_sq_in_xla_order`).  Fed JAX's own features, this elects JAX's
    # eager heads in all 207 plans of a sweep at K = 8, 16, 50 and all
    # 1,050 of one at K = 65, 80, 100, 127, 200 (C = 2, 3, 5), and its
    # jitted heads in the sweep of `tests/test_torch_election.py`.  The
    # port's own features of the same link SNRs are XLA's bits
    # (`xla_math.db10`) and elect the same heads there, and its channel
    # view is JAX's bit for bit (`xla_math.xla_channel_view`), so a run
    # re-clusters on JAX's SNRs.
    diff = feats[:, None, :] - centroids[None]
    d2 = _sum_sq_in_xla_order(diff, jitted)
    d2_masked = torch.where(assign[:, None] == clusters[None], d2,
                            torch.inf)
    heads = torch.argmin(d2_masked, dim=0)                        # (C,)

    membership = (assign[None, :] == clusters[:, None]).to(torch.float32)
    return _with_heads(assign, membership, heads, link_snr)


def _with_heads(assignment: torch.Tensor, membership: torch.Tensor,
                heads: torch.Tensor, link_snr: torch.Tensor) -> ClusterPlan:
    """The plan of these clusters under these heads: ξ_c is the mean
    member→head link SNR, excluding the head's zero self-link."""
    K = link_snr.shape[0]
    snr_to_head = link_snr[heads]                                 # (C, K)
    head_onehot = F.one_hot(heads, K).to(torch.float32)           # (C, K)
    member_not_head = membership * (1.0 - head_onehot)
    denom = torch.clamp(member_not_head.sum(1), min=1.0)
    cluster_snr = (snr_to_head * member_not_head).sum(1) / denom
    # Singleton clusters (head only): max SNR (noiseless local aggregate).
    cluster_snr = torch.where(member_not_head.sum(1) > 0, cluster_snr,
                              torch.max(link_snr))
    return ClusterPlan(assignment=assignment, heads=heads,
                       membership=membership, cluster_snr=cluster_snr,
                       head_mask=head_onehot.sum(0))


def reelect_heads(plan: ClusterPlan, link_snr: torch.Tensor,
                  alive: torch.Tensor) -> ClusterPlan:
    """Head-failure handoff: a cluster whose head is up keeps it; a dead
    head is replaced by the live member with the largest within-cluster
    aggregate link SNR Σ_j membership[c,j]·ξ_{k,j} (``argmax``, first
    occurrence, as JAX's); a fully dead cluster keeps its dead head, which
    the alive-aware round coefficients make inert
    (`cwfl.round_coefficients`).  Membership is untouched; ξ_c follows the
    new heads, by `make_cluster_plan`'s rule."""
    a = alive.to(torch.float32)
    score = plan.membership @ link_snr.T                          # (C, K)
    cand = plan.membership * a[None, :]                           # (C, K)
    elig = torch.where(cand > 0, score, -torch.inf)
    new_heads = torch.argmax(elig, dim=1)                         # (C,)
    any_cand = torch.any(cand > 0, dim=1)
    keep = a[plan.heads] > 0
    heads = torch.where(keep, plan.heads,
                        torch.where(any_cand, new_heads, plan.heads))
    return _with_heads(plan.assignment, plan.membership, heads, link_snr)


def consensus_weights(cluster_snr: torch.Tensor) -> torch.Tensor:
    """Paper eq. (9): W(c, j) = ξ_j / Σ_{j'≠c} ξ_{j'}, W(c, c) = 0.  Rows
    index the receiving head c; each row sums to 1 over j ≠ c."""
    C = cluster_snr.shape[0]
    xi = cluster_snr.to(torch.float32)
    off = 1.0 - torch.eye(C, device=xi.device)
    denom = (off * xi[None, :]).sum(dim=1, keepdim=True)
    return off * xi[None, :] / torch.clamp(denom, min=1e-12)
