"""Per-client local training between sync rounds (eq. 2 top row).

Port of `repro.training.local`, batched over the K clients: the stacked
params (every leaf (K, ...)) train together, one minibatch-SGD step at a
time.  The backward pass runs over the SUM of the per-client mean losses,
so each client's gradient is its own (a mean over K would scale them by
1/K).  The minibatch indices come in as a ``(K, steps, batch)`` tensor
(JAX draws them with ``randint`` per client and step).  FedProx (paper §V)
adds the proximal term (µ_p/2)·‖θ_k − θ_g‖² to each client's loss, against
its params at the last sync.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.pytree import (tree_flatten, tree_leaves,
                                      tree_unflatten)


def fedprox_wrap(loss_fn: Callable, mu_prox: float) -> Callable:
    """``prox_loss(params, x, y, global_params)``: each client's loss plus
    (µ_p/2)·‖params_k − global_k‖², the squared distance summed over every
    leaf in f32.  ``params`` and ``global_params`` are K-stacked, so the
    result is (K,), one term a client (paper §V)."""

    def prox_loss(params, x, y, global_params):
        sq = 0.0
        for p, g in zip(tree_leaves(params), tree_leaves(global_params)):
            diff = p.to(torch.float32) - g.to(torch.float32)
            sq = sq + torch.sum(torch.square(diff).reshape(p.shape[0], -1),
                                dim=1)
        return loss_fn(params, x, y) + 0.5 * mu_prox * sq

    return prox_loss


def make_local_runner(loss_fn: Callable, optimizer, batch_size: int,
                      local_steps: int, mu_prox: float = 0.0):
    """Returns ``run(params, opt_state, x, y, idx, rows=None) -> (params,
    opt_state, loss)`` running ``local_steps`` minibatch steps of
    ``optimizer`` on every client (its ``update`` gets the leaves, as JAX's
    runner passes the params).

    ``loss_fn(params, x, y)`` maps K-stacked params and (K, B, ...) inputs
    to (K,) per-client mean losses; ``x``/``y`` are the (K, N_k, ...)
    client shards; ``idx`` the (n, local_steps, batch_size) minibatch
    indices of the n stacked clients, each into its own shard.  ``rows``:
    the (n,) int64 shard of each stacked client (default: client k trains
    on shard k), so that the S·K clients of S stacked trajectories read
    the K shards without copying them.  ``loss`` is each client's (n,)
    mean loss over its steps.  ``mu_prox > 0`` trains on
    :func:`fedprox_wrap`'s objective, anchored at ``params`` as they come
    in, and reports it.
    """
    if mu_prox > 0.0:
        loss_fn = fedprox_wrap(loss_fn, mu_prox)

    def run(params, opt_state, x, y, idx, rows=None):
        if rows is None:
            rows = torch.arange(x.shape[0], device=x.device)
        n = rows.shape[0]
        if tuple(idx.shape) != (n, local_steps, batch_size):
            raise ValueError(f"idx must be {(n, local_steps, batch_size)}, "
                             f"got {tuple(idx.shape)}")
        leaves, treedef = tree_flatten(params)
        anchor = ((tree_unflatten(treedef, [p.detach() for p in leaves]),)
                  if mu_prox > 0.0 else ())
        rows = rows[:, None]
        losses = []
        for step in range(local_steps):
            batch = idx[:, step]
            p = [leaf.detach().requires_grad_(True) for leaf in leaves]
            loss = loss_fn(tree_unflatten(treedef, p), x[rows, batch],
                           y[rows, batch], *anchor)
            grads = torch.autograd.grad(loss.sum(), p)
            updates, opt_state = optimizer.update(grads, opt_state, leaves)
            with torch.no_grad():
                leaves = [leaf + u for leaf, u in zip(leaves, updates)]
            losses.append(loss.detach())
        loss = torch.stack(losses, dim=1).mean(dim=1)
        return tree_unflatten(treedef, leaves), opt_state, loss

    return run
