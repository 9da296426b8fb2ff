"""Single-model train and serve step builders (port of
`repro.training.steps`); the distributed versions wrap these with the
CWFL gradient collective (`repro_torch.training.dist_steps`).

The train step's gradient runs through autograd, attention's through the
hand-written backward kernel on the card
(`repro_torch.kernels.flash_attention.FlashAttentionFn`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig
from repro_torch.utils.pytree import tree_flatten, tree_unflatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in f32.  logits: (B, S, V), labels: (B, S) ints."""
    return torch.mean(token_cross_entropy(logits, labels))


def token_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """(B, S) f32: logsumexp of each position's logits less its label's."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss,
    aux)``: the counterpart of ``jax.value_and_grad(..., has_aux=True)``,
    with ``grads`` a list of tensors in leaf order.  The params are used
    through detached views, so the caller's tensors never require grad."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(treedef, live), *args)
        grads = torch.autograd.grad(loss, live)
    return (loss.detach(), aux.detach()), list(grads)


def text_logits(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The logits of the text positions: the VLM's patch prefix has no
    labels."""
    if cfg.frontend == "vision_stub":
        return logits[:, cfg.prefix_tokens:]
    return logits


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """(params, batch) -> (loss, ce); loss = ce + router_aux_weight × the
    MoE routers' loss (0 without MoE)."""
    def loss_fn(params, batch):
        logits, aux = tfm.forward(params, batch, cfg)
        ce = cross_entropy(text_logits(logits, cfg), batch["labels"])
        return ce + cfg.router_aux_weight * aux, ce
    return loss_fn


def make_train_step(cfg: ArchConfig, optimizer) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss", "ce"});
    ``optimizer`` from `repro_torch.optim`.  The params come back new,
    as JAX's do; the old ones are left as they were."""
    loss_fn = make_loss_fn(cfg)

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        (loss, ce), grads = value_and_grad(loss_fn, params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        params = tree_unflatten(treedef, [p + u for p, u in
                                          zip(leaves, updates)])
        return params, opt_state, {"loss": loss, "ce": ce}

    return step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> (last_logits (B, 1, V), caches)."""
    def step(params, batch):
        return tfm.prefill(params, batch, cfg)
    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token (B, 1), caches, pos, enc_kv=None) -> (logits (B, 1,
    V), deltas)."""
    def step(params, token, caches, pos, enc_kv=None):
        return tfm.decode_step(params, token, caches, pos, cfg,
                               enc_kv=enc_kv)
    return step
