"""Carry arrays across from the JAX reference as numpy.

The port keeps the JAX package's layouts (a dense layer's ``w`` is
``(d_in, d_out)``, not ``nn.Linear``'s ``(out, in)``), so conversion is a
copy, leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import COTAFState, DecentralizedState
from repro_torch.core.clustering import ClusterPlan
from repro_torch.core.cwfl import CWFLState
from repro_torch.core.topology import Topology, TopologyConfig, link_stats
from repro_torch.dist.fl_integration import FLPlan


def _tensor(x, device, dtype=None) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch cannot read: carried across as
        # its bits, so the tensor is the array bit for bit.
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.as_tensor(x, dtype=dtype, device=device)


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


def cwfl_state_from_arrays(plan, client_power, total_power,
                           head_noise_std, consensus_noise_std, mix, *,
                           device) -> CWFLState:
    """A `CWFLState` from the reference's arrays, copied as they are;
    ``plan`` holds the five arrays of :func:`plan_from_arrays`, in its
    order."""
    return CWFLState(
        plan=plan_from_arrays(*plan, device=device),
        client_power=_tensor(client_power, device, torch.float32),
        total_power=float(total_power),
        head_noise_std=_tensor(head_noise_std, device, torch.float32),
        consensus_noise_std=_tensor(consensus_noise_std, device,
                                    torch.float32),
        mix=_tensor(mix, device, torch.float32))


def cotaf_state_from_arrays(client_power, total_power, noise_std, server,
                            *, device) -> COTAFState:
    """A `COTAFState` from the reference's arrays (``server`` may be
    ``None``)."""
    return COTAFState(
        client_power=_tensor(client_power, device, torch.float32),
        total_power=float(total_power),
        noise_std=_tensor(noise_std, device, torch.float32),
        server=None if server is None else _tensor(server, device,
                                                   torch.int64))


def decentralized_state_from_arrays(mixing, noise_std, total_power, *,
                                    device) -> DecentralizedState:
    """A `DecentralizedState` from the reference's arrays."""
    return DecentralizedState(
        mixing=_tensor(mixing, device, torch.float32),
        noise_std=_tensor(noise_std, device, torch.float32),
        total_power=float(total_power))


def fl_plan_from_arrays(fields: dict, state: CWFLState) -> FLPlan:
    """A port `FLPlan` from the reference's: ``fields`` holds every field
    of JAX's ``FLPlan`` but ``state`` (numpy arrays and Python numbers),
    ``state`` its ``CWFLState`` carried by :func:`cwfl_state_from_arrays`,
    so both packages compute from the same plan."""
    arrays = {name: np.array(fields[name]) for name in (
        "beta", "assignment", "heads", "mix", "cluster_weights",
        "phase1_rel_std", "phase2_rel_std")}
    return FLPlan(num_clients=int(fields["num_clients"]),
                  num_clusters=int(fields["num_clusters"]),
                  noise_std=float(fields["noise_std"]),
                  snr_db=float(fields["snr_db"]), state=state, **arrays)
