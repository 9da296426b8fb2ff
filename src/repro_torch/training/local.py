"""Per-client local training between sync rounds (eq. 2 top row).

Port of `repro.training.local`, batched over the K clients: the stacked
params (every leaf (K, ...)) train together, one minibatch-SGD step at a
time.  The backward pass runs over the SUM of the per-client mean losses,
so each client's gradient is its own (a mean over K would scale them by
1/K).  The minibatch indices come in as a ``(K, steps, batch)`` tensor
(JAX draws them with ``randint`` per client and step).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.pytree import tree_flatten, tree_unflatten


def make_local_runner(loss_fn: Callable, optimizer, batch_size: int,
                      local_steps: int):
    """Returns ``run(params, opt_state, x, y, idx) -> (params, opt_state,
    loss)`` running ``local_steps`` minibatch-SGD steps on every client.

    ``loss_fn(params, x, y)`` maps K-stacked params and (K, B, ...) inputs
    to (K,) per-client mean losses; ``x``/``y`` are the (K, N_k, ...)
    client shards; ``idx`` the (K, local_steps, batch_size) minibatch
    indices into each shard.  ``loss`` is each client's (K,) mean loss
    over its steps.
    """

    def run(params, opt_state, x, y, idx):
        K = x.shape[0]
        if tuple(idx.shape) != (K, local_steps, batch_size):
            raise ValueError(f"idx must be {(K, local_steps, batch_size)}, "
                             f"got {tuple(idx.shape)}")
        leaves, treedef = tree_flatten(params)
        rows = torch.arange(K, device=x.device)[:, None]
        losses = []
        for step in range(local_steps):
            batch = idx[:, step]
            p = [leaf.detach().requires_grad_(True) for leaf in leaves]
            loss = loss_fn(tree_unflatten(treedef, p), x[rows, batch],
                           y[rows, batch])
            grads = torch.autograd.grad(loss.sum(), p)
            updates, opt_state = optimizer.update(grads, opt_state)
            with torch.no_grad():
                leaves = [leaf + u for leaf, u in zip(leaves, updates)]
            losses.append(loss.detach())
        loss = torch.stack(losses, dim=1).mean(dim=1)
        return tree_unflatten(treedef, leaves), opt_state, loss

    return run
