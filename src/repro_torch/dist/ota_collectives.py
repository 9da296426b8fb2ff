"""Flat-vector and collective lowerings of the CWFL aggregation (port of
`repro.dist.ota_collectives`).

Two entry families:

* ``phase1_ota_flat`` / ``cwfl_aggregate_flat`` — Algorithm 1 on a flat
  ``(K, d)`` client-signal matrix, with the channel math of
  `repro_torch.core.cwfl.round_coefficients` verbatim: phase 1 through the
  `ota_aggregate` kernel, the full round through the fused `cwfl_round`
  kernel.
* ``ota_allreduce_tree`` / ``build_gradient_allreduce`` — the hierarchical
  two-phase OTA all-reduce applied to parameter or gradient trees across a
  ``torch.distributed`` group, one client a rank (JAX's mesh ``data`` axis
  becomes the process group).

The noise comes in as unit normals: one (C, d) matrix for phase 1, two for
the full round.  The JAX ``tile``/``interpret``/``use_pallas`` arguments
are TPU choices and are gone: on the card the kernels run at every d.
"""
from __future__ import annotations

import torch

from repro_torch.core import cwfl
from repro_torch.core.cwfl import CWFLState
from repro_torch.dist.fl_integration import (FLPlan, _check_world,
                                             hierarchical_ota_allreduce)
from repro_torch.kernels.cwfl_round import cwfl_round
from repro_torch.kernels.ota_aggregate import ota_aggregate
from repro_torch.utils.pytree import (tree_flatten_vector, tree_map,
                                      tree_unflatten_vector)


def phase1_ota_flat(signals: torch.Tensor, state: CWFLState,
                    noise: torch.Tensor, *, normalize: bool = True,
                    precode: bool = True) -> torch.Tensor:
    """Phase-1 OTA MAC on flat vectors: ``(K, d) -> (C, d)`` f32 (eq. 8).

    ``noise``: (C, d) f32 unit normals, scaled by the round's effective
    phase-1 receiver stds.  Matches the first phase of
    `repro_torch.core.cwfl.aggregate` on the flattened tree;
    ``normalize``/``precode`` as there."""
    sig32 = signals.to(torch.float32)
    a, eff_std, _, _, _ = cwfl.round_coefficients(
        state, sig32, normalize=normalize, precode=precode)
    return ota_aggregate(sig32, a, eff_std[:, None] * noise)


def cwfl_aggregate_flat(signals: torch.Tensor, state: CWFLState, noise, *,
                        normalize: bool = True, precode: bool = True):
    """Full Algorithm 1 on a flat ``(K, d)`` matrix through the fused round.

    ``noise``: ``(unit1, unit2)``, two (C, d) f32 unit-normal matrices for
    phase 1 and phase 2.  Returns ``(new_signals (K, d) in the signals'
    dtype, consensus (d,) f32)`` — the flat twin of
    `repro_torch.core.cwfl.aggregate`, equal to it on the same normals
    (``normalize``/``precode`` as there)."""
    sig32 = signals.to(torch.float32)
    a, eff_std, b, kappa, m_back = cwfl.round_coefficients(
        state, sig32, normalize=normalize, precode=precode)
    unit1, unit2 = noise
    new32, consensus = cwfl_round(sig32, a, eff_std[:, None] * unit1, b,
                                  kappa[:, None] * unit2, m_back)
    return new32.to(signals.dtype), consensus


def ota_allreduce_tree(tree, plan: FLPlan, noise, group=None):
    """Aggregate this rank's parameter or gradient tree across ``group``
    with the hierarchical OTA collective; every rank returns the same
    consensus tree.  ``noise``: ``(unit1, unit2)``, two (C, d) unit-normal
    matrices over the flat leaf order, the same on every rank."""
    flat = tree_flatten_vector(tree)
    out = hierarchical_ota_allreduce(flat, plan, noise, group)
    return tree_unflatten_vector(out, tree)


def build_gradient_allreduce(plan: FLPlan, group=None):
    """The collective over K-stacked client trees, one client a rank.

    The returned ``agg(local_tree, noise)`` maps this rank's slice of the
    stacked tree (leaves ``(1, ...)``) to the same shape holding the OTA
    consensus.  The group's size must be ``plan.num_clients``."""
    _check_world(plan, group)

    def agg(local_tree, noise):
        local = tree_map(lambda x: x[0], local_tree)
        out = ota_allreduce_tree(local, plan, noise, group)
        return tree_map(lambda x: x[None], out)

    return agg
