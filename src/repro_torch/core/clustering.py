"""SNR-aware, data-agnostic client clustering (paper §IV).

Port of `repro.core.clustering`.  Each client's feature is its link-SNR
profile (dB, outage links floored); K-means groups clients, and the member
nearest each centroid becomes its cluster-head.  ``argmin``/``argmax``
return the first occurrence, as JAX's do; the head election departs from
JAX on ties (see `make_cluster_plan`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


# Relative distance within which two cluster members tie for head: a few
# f32 ulp of a 16..50-term sum of squares.
_HEAD_TIE_RTOL = 1e-6


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
        return int(self.heads.shape[0])


def _kmeans(features: torch.Tensor, num_clusters: int, first: int,
            iters: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd K-means with farthest-point initialization from the given
    first centre (JAX draws it with ``randint(key, (), 0, K)``; the caller
    draws it here, so the reference's pick can be passed in)."""
    C = num_clusters
    centers = [int(first)]
    for _ in range(1, C):
        d2 = torch.sum((features[:, None, :] - features[centers][None]) ** 2,
                       dim=-1)
        centers.append(int(torch.argmax(torch.min(d2, dim=1).values)))
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


def snr_features(link_snr: torch.Tensor, adjacency: torch.Tensor,
                 floor_db: float = -30.0) -> torch.Tensor:
    """Per-client SNR profile features (dB, outage links floored)."""
    snr_db = 10.0 * torch.log10(torch.clamp(link_snr, min=1e-12))
    snr_db = torch.where(adjacency, snr_db, floor_db)
    return torch.clamp(snr_db, min=floor_db)


def make_cluster_plan(link_snr: torch.Tensor, adjacency: torch.Tensor,
                      num_clusters: int, first: int,
                      kmeans_iters: int = 50) -> ClusterPlan:
    """Full offline clustering: K-means on SNR features → heads → ξ_c."""
    K = link_snr.shape[0]
    C = num_clusters
    feats = snr_features(link_snr, adjacency)
    assign, centroids = _kmeans(feats, C, first, kmeans_iters)
    clusters = torch.arange(C, device=link_snr.device)

    # Head of cluster c = member closest to centroid c (paper §IV).  A
    # two-member cluster puts both members at the same distance from its
    # centroid in exact arithmetic; in f32 the rounding of the features
    # (log10) and of the sum of squares decides, and ATen rounds otherwise
    # than XLA.  Here distances within _HEAD_TIE_RTOL of the nearest count
    # as tied and the lowest index wins, so the choice does not hang on
    # rounding.  JAX has no such rule: where its rounding favours the
    # higher index (K=16, topology seed 4, C=5: head 13 of {0, 13}), and on
    # genuine near-ties closer than _HEAD_TIE_RTOL, the port elects
    # another head than JAX.
    d2 = torch.sum((feats[:, None, :] - centroids[None]) ** 2, dim=-1)
    d2_masked = torch.where(assign[:, None] == clusters[None], d2,
                            torch.inf)
    nearest = torch.min(d2_masked, dim=0).values
    tied = d2_masked <= nearest * (1.0 + _HEAD_TIE_RTOL)
    heads = torch.argmax(tied.to(torch.int32), dim=0)             # (C,)

    membership = (assign[None, :] == clusters[:, None]).to(torch.float32)

    # ξ_c: mean member→head link SNR (excluding the head's zero self-link).
    snr_to_head = link_snr[heads]                                 # (C, K)
    head_onehot = F.one_hot(heads, K).to(torch.float32)           # (C, K)
    member_not_head = membership * (1.0 - head_onehot)
    denom = torch.clamp(member_not_head.sum(1), min=1.0)
    cluster_snr = (snr_to_head * member_not_head).sum(1) / denom
    # Singleton clusters (head only): max SNR (noiseless local aggregate).
    cluster_snr = torch.where(member_not_head.sum(1) > 0, cluster_snr,
                              torch.max(link_snr))
    return ClusterPlan(assignment=assign, heads=heads, membership=membership,
                       cluster_snr=cluster_snr,
                       head_mask=head_onehot.sum(0))


def consensus_weights(cluster_snr: torch.Tensor) -> torch.Tensor:
    """Paper eq. (9): W(c, j) = ξ_j / Σ_{j'≠c} ξ_{j'}, W(c, c) = 0.  Rows
    index the receiving head c; each row sums to 1 over j ≠ c."""
    C = cluster_snr.shape[0]
    xi = cluster_snr.to(torch.float32)
    off = 1.0 - torch.eye(C, device=xi.device)
    denom = (off * xi[None, :]).sum(dim=1, keepdim=True)
    return off * xi[None, :] / torch.clamp(denom, min=1e-12)
