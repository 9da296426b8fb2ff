"""Carry arrays across from the JAX reference as numpy.

The port keeps the JAX package's layouts (a dense layer's ``w`` is
``(d_in, d_out)``, not ``nn.Linear``'s ``(out, in)``), so conversion is a
copy, leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import ClusterPlan
from repro_torch.core.topology import Topology, TopologyConfig, link_stats


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def params_from_jax(np_tree, *, device) -> dict:
    """A JAX param dict (``{"fc0": {"w": ..., "b": ...}, ...}``, leaves as
    numpy arrays) to the port's params: same names, shapes and dtypes."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device=device)
                for k, v in np_tree.items()}
    return _tensor(np_tree, device)


def topology_from_arrays(positions, link_gain, cfg: TopologyConfig, *,
                         device) -> Topology:
    """A `Topology` from the reference's (K, 2) positions and (K, K)
    complex link gains; SNRs and the outage graph are re-derived with the
    port's `link_stats`."""
    link_gain = _tensor(link_gain, device, torch.complex64)
    link_snr, adjacency = link_stats(link_gain, cfg)
    return Topology(positions=_tensor(positions, device, torch.float32),
                    link_gain=link_gain, link_snr=link_snr,
                    adjacency=adjacency, noise_var=cfg.noise_var,
                    total_power=cfg.total_power)


def plan_from_arrays(assignment, heads, membership, cluster_snr, head_mask,
                     *, device) -> ClusterPlan:
    """A `ClusterPlan` from the reference's arrays."""
    return ClusterPlan(
        assignment=_tensor(assignment, device, torch.int64),
        heads=_tensor(heads, device, torch.int64),
        membership=_tensor(membership, device, torch.float32),
        cluster_snr=_tensor(cluster_snr, device, torch.float32),
        head_mask=_tensor(head_mask, device, torch.float32))
