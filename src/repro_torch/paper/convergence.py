"""Theorem 1 empirically: per-cluster O(1/T) error decay on a strongly-
convex quadratic, with the SNR-dependent Q₂ floor.  Twin of the JAX
package's ``benchmarks/convergence.py`` and of the quadratic of its
``tests/test_convergence.py``.

Clients hold f_k(θ) = ½‖θ − a_k‖² (L = µ = 1).  The paper's objective
(eq. 1) is the p_k-weighted sum F(θ) = Σ p_k f_k(θ) with the p_k of the
OTA aggregation, so CWFL's optimum θ* is the SNR/power-weighted
combination of the a_k, not their uniform mean: the error is measured
against the empirical fixed point of the noiseless dynamics (a long run
at 60 dB), with the step size η_t = 2/(µ(γ+t)), γ = 12.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import cwfl
from repro_torch.core.topology import TopologyConfig, make_topology
from repro_torch.optim import inverse_time_schedule
from repro_torch.utils.device import resolve_device

_SCHEDULE = dict(mu=1.0, gamma=12.0)


def quadratic_problem(seed: int = 0, K: int = 12, d: int = 16,
                      snr_db: float = 60.0, device=None):
    """``(state, a)``: the CWFL state of a K-client topology around 3
    hotspots (C = 3 at ``snr_db``) and the (K, d) client optima a_k, drawn
    from ``seed`` on ``device`` (``None`` = the GPU)."""
    device = resolve_device(device)
    topo = make_topology(seed, TopologyConfig(num_clients=K, num_hotspots=3),
                         device=device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    first = int(torch.randint(K, (), generator=gen, device=device))
    state = cwfl.setup(topo, cwfl.CWFLConfig(num_clusters=3, snr_db=snr_db),
                       first)
    return state, torch.randn(K, d, generator=gen, device=device)


def _noiseless(state: cwfl.CWFLState) -> cwfl.CWFLState:
    """``state`` with both receivers' noise stds at 0."""
    return dataclasses.replace(
        state, head_noise_std=state.head_noise_std * 0.0,
        consensus_noise_std=state.consensus_noise_std * 0.0)


def run_quadratic(state: cwfl.CWFLState, a: torch.Tensor, T: int,
                  theta_star: torch.Tensor, E: int = 1,
                  noise_seed: int = 0) -> np.ndarray:
    """Per-round squared error ‖θ̄_t − θ*‖² of the consensus over T rounds
    of E gradient steps at η_t, each followed by one CWFL sync whose unit
    normals come from a generator seeded with ``noise_seed``."""
    K, d = a.shape
    C = state.num_clusters
    sched = inverse_time_schedule(**_SCHEDULE)
    gen = torch.Generator(a.device).manual_seed(noise_seed)
    theta = {"x": torch.zeros(K, d, device=a.device)}
    errs = []
    for t in range(T):
        eta = sched(t)
        for _ in range(E):
            theta = {"x": theta["x"] - eta * (theta["x"] - a)}
        noise = tuple(torch.randn(C, d, generator=gen, device=a.device)
                      for _ in range(2))
        theta, cons = cwfl.aggregate(theta, state, noise)
        errs.append(torch.sum((cons["x"] - theta_star) ** 2))
    return torch.stack(errs).cpu().numpy()


def fixed_point(state: cwfl.CWFLState, a: torch.Tensor,
                T: int = 400) -> torch.Tensor:
    """The empirical optimum: the consensus of the noiseless dynamics run
    for T rounds."""
    K, d = a.shape
    state = _noiseless(state)
    sched = inverse_time_schedule(**_SCHEDULE)
    zeros = torch.zeros(state.num_clusters, d, device=a.device)
    theta = {"x": torch.zeros(K, d, device=a.device)}
    for t in range(T):
        theta = {"x": theta["x"] - sched(t) * (theta["x"] - a)}
        theta, cons = cwfl.aggregate(theta, state, (zeros, zeros))
    return cons["x"]


def run_cwfl_quadratic(T: int, snr_db: float, seed: int = 0, K: int = 12,
                       d: int = 16, E: int = 1,
                       theta_star: Optional[torch.Tensor] = None,
                       noiseless: bool = False, device=None
                       ) -> np.ndarray:
    """Per-round squared error of the consensus to ``theta_star`` (default:
    the fixed point of the problem drawn from ``seed`` at 60 dB)."""
    state, a = quadratic_problem(seed, K, d, snr_db, device)
    if noiseless:
        state = _noiseless(state)
    if theta_star is None:
        theta_star = fixed_point(*quadratic_problem(seed, K, d,
                                                    device=a.device))
    return run_quadratic(state, a, T, theta_star, E, noise_seed=seed + 123)


def run(T: int = 150, device=None) -> dict:
    """Error at T/4 and T, their ratio, and the floor (mean of the last 10
    rounds) at 10, 20 and 40 dB."""
    out = {}
    for snr in (10.0, 20.0, 40.0):
        errs = run_cwfl_quadratic(T=T, snr_db=snr, device=device)
        rate = errs[T // 4] / max(errs[-1], 1e-12)
        out[f"snr{int(snr)}"] = {
            "err_T4": float(errs[T // 4]),
            "err_T": float(errs[-1]),
            "decay_T4_to_T": float(rate),
            "floor": float(np.mean(errs[-10:])),
        }
    return out
