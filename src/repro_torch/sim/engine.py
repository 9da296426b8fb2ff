"""The FL round loop for the static scenario (port of `repro.sim.engine`).

The JAX engine scans rounds on device; here the rounds are a Python loop
(PyTorch runs eagerly).  One round:

    local:  E epochs of minibatch SGD per client   (batched over K)
    sync:   strategy aggregation — CWFL through the fused round kernel
    eval:   consensus accuracy on ``x_test[:eval_samples]``

Per-round metrics stay on the device until the run ends, unless a
``progress`` callback asks for them each round.  Only the static
``paper-static`` scenario is ported; the scenario processes (fading,
scheduling, faults, re-clustering) come with a later slice.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.models.small import accuracy
from repro_torch.optim import sgd
from repro_torch.sim.draws import Draws, TorchDraws
from repro_torch.strategies import get_strategy
from repro_torch.training.local import make_local_runner
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map, tree_size

STATIC_SCENARIO = "paper-static"


@contextlib.contextmanager
def _full_f32():
    """TF32 off for the run, the caller's flags back after it: the JAX
    reference computes in full f32, and TF32 would keep ~3 digits."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def run_rounds(init_fn: Callable, apply_fn: Callable, loss_fn: Callable,
               topology: Topology, xs: torch.Tensor, ys: torch.Tensor,
               x_test: torch.Tensor, y_test: torch.Tensor, cfg,
               scenario: Optional[str] = None,
               progress: Optional[Callable] = None,
               draws: Optional[Draws] = None,
               device=None) -> dict[str, Any]:
    """Run one FL trajectory; returns a history of per-round metrics.

    ``xs, ys``: stacked client shards (K, N_k, ...).  ``loss_fn(params, x,
    y)`` must take K-stacked params and (K, B, ...) batches.
    ``scenario``: ``None`` or ``"paper-static"``; others are not ported.
    ``progress(r, loss, acc)``: optional per-round callback (syncs the host
    every round).  ``draws``: the run's random draws (default: `TorchDraws`
    seeded from ``cfg.seed`` on ``device``).  ``device``: where the run
    happens (``None`` = the GPU); inputs are moved there.
    """
    if scenario not in (None, STATIC_SCENARIO):
        raise NotImplementedError(
            f"scenario {scenario!r}: only {STATIC_SCENARIO!r} is ported")
    if cfg.mu_prox > 0:
        raise NotImplementedError("FedProx (mu_prox > 0) is not ported yet")
    device = resolve_device(device)
    with _full_f32():
        strategy = get_strategy(cfg.strategy)
        topology = topology.to(device)
        xs, ys = xs.to(device), ys.to(device)
        x_ev = x_test[: cfg.eval_samples].to(device)
        y_ev = y_test[: cfg.eval_samples].to(device)
        draws = draws if draws is not None else TorchDraws(cfg.seed, device)
        K, n_k = xs.shape[0], xs.shape[1]
        # E epochs of minibatch SGD over each client's n_k examples.
        steps = max(cfg.local_epochs * (n_k // cfg.batch_size), 1)
        optimizer = sgd(cfg.lr)
        local_run = make_local_runner(loss_fn, optimizer, cfg.batch_size,
                                      steps)

        state = strategy.init(topology, draws, cfg, snr_db=cfg.snr_db)
        consensus = tree_map(lambda x: x.to(device),
                             draws.init_params(init_fn))
        stacked = tree_map(lambda x: x.expand((K,) + x.shape).clone(),
                           consensus)
        opt_state = optimizer.init(stacked)
        d = tree_size(consensus)

        losses, accs = [], []
        for t in range(cfg.rounds):
            idx = draws.batch_indices(t, K, steps, cfg.batch_size, n_k)
            trained, opt_state, client_loss = local_run(
                stacked, opt_state, xs, ys, idx.to(device))
            unit1, unit2 = draws.phase_noise(t, cfg.num_clusters, d)
            with torch.no_grad():
                stacked, consensus = strategy.aggregate(
                    trained, state, (unit1.to(device), unit2.to(device)))
                acc = accuracy(apply_fn(consensus, x_ev), y_ev)
            loss = torch.mean(client_loss)
            losses.append(loss)
            accs.append(acc)
            if progress is not None:
                progress(t + 1, float(loss), float(acc))

        loss, acc = torch.stack(losses), torch.stack(accs)
        return {
            "round": np.arange(1, cfg.rounds + 1),
            "train_loss": loss,
            "test_acc": acc,
            "final_params": consensus,
            "avg_acc": torch.mean(acc),
            "final_acc": acc[-1],
        }
