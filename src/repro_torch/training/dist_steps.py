"""Distributed train step builders on one card (port of
`repro.training.dist_steps`).

Shard mode (:func:`make_train_step`): one model copy; CWFL enters as
per-example consensus loss weights and post-backward channel noise
(`repro_torch.dist.fl_integration`), over M microbatches whose gradients
are summed in ``accum_dtype``.  Replica mode
(:func:`make_replica_train_step`): the clients' parameters stacked on a
leading K axis, each client's local SGD steps, then the paper's
Algorithm-1 aggregation (`repro_torch.core.cwfl.aggregate`) across the
client axis, through the fused round kernel.

The serve builders: :func:`make_prefill_step` and
:func:`make_decode_step` (with JAX's ``window_override``, the long_500k
sliding-window variant, and ``replicate_cache_heads``, a mesh layout that
one card already has).

JAX's builders return ``(fn, args_shape_structs, in_shardings)`` (and the
prefill step its cache's out-shardings) for its dry-run path over a
device mesh.  One card has no mesh, so these return the step function
alone, and :func:`auto_microbatches` takes the data- and model-parallel
widths as numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import cwfl as cwfl_core
from repro_torch.dist.fl_integration import FLPlan
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.optim import sgd
from repro_torch.training.steps import (text_logits, token_cross_entropy,
                                       value_and_grad)
from repro_torch.utils.pytree import tree_flatten, tree_size, tree_unflatten

Noise = Union[torch.Generator, list]


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (JAX's ``eval_shape`` of ``init_params``)."""
    return tfm.init_params(0, cfg, device="meta")


def _weighted_ce(logits, labels, ex_weights):
    """Mean over examples of (mean token CE of the example) · its weight,
    in f32."""
    per_ex = torch.mean(token_cross_entropy(logits, labels), dim=-1)
    return torch.mean(per_ex * ex_weights)


def auto_microbatches(cfg: ArchConfig, shape: InputShape, *, dp: int = 1,
                      tp: int = 1, budget_bytes: float = 2e9) -> int:
    """Gradient-accumulation factor M such that a device's saved remat
    inputs (L × (B/M/dp) × S × (d/tp) × 2 bytes), its CE logits and, for
    MoE, its dispatch buffers fit the activation budget: JAX's formula,
    with ``dp`` (1 on one card, a process group's size over one) and
    ``tp`` given as numbers instead of read off a mesh."""
    d_sh = cfg.d_model // tp if cfg.d_model % tp == 0 else cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    per_m1 = cfg.num_layers * max(B // dp, 1) * S * d_sh * 2
    # CE logits are (B/dp, S, V) in bf16 + f32 on each device.
    per_m1 = max(per_m1, max(B // dp, 1) * S * cfg.vocab_size * 6)
    if cfg.num_experts > 0:
        per_m1 = max(per_m1,
                     B * S * cfg.top_k * cfg.capacity_factor
                     * cfg.d_model * 2 * 2 / dp)
    m = 1
    max_m = max(B // dp, 1)
    while per_m1 / m > budget_bytes and m < max_m:
        m *= 2
    return min(m, max_m)


def make_train_step(cfg: ArchConfig, shape: InputShape, *,
                    plan: Optional[FLPlan] = None, lr: float = 1e-3,
                    microbatches: Optional[int] = None,
                    accum_dtype: torch.dtype = torch.float32,
                    ce_mode: str = "gather", donate: bool = False):
    """Shard-mode train step: CWFL consensus weighting and channel noise,
    gradient accumulation over M microbatches (auto-sized to the
    activation budget), SGD (the paper's optimizer).

    ``(params, opt_state, batch, noise) -> (params, opt_state, {"loss",
    "ce"})``, where JAX's step takes a key: ``noise`` is one unit-normal
    tensor a leaf in leaf order (JAX draws ``normal(k, x.shape,
    x.dtype)`` with one key a leaf) or a ``torch.Generator``.  The params
    come back new (a copy that the update is applied to); the old ones
    are left as they were.

    ``accum_dtype``: the microbatch-gradient accumulator's dtype (bf16
    halves it; the channel noise dominates bf16 rounding).
    ``ce_mode``: ``"resharded"`` is a mesh hint in JAX (batch-shard the
    logits before the CE); on one card it computes what ``"gather"``
    computes.
    ``donate``: JAX's ``donate_argnums=(0, 1)``.  The update is applied
    to the caller's params, whose tensors come back updated (the old
    values are gone), instead of to a copy: the same arithmetic, so the
    same bits, without the copy's bytes."""
    if ce_mode not in ("gather", "resharded"):
        raise ValueError(f"ce_mode is 'gather' or 'resharded', got "
                         f"{ce_mode!r}")
    optimizer = sgd(lr)
    B = shape.global_batch
    M = microbatches if microbatches is not None else auto_microbatches(
        cfg, shape)
    if B % M:
        raise ValueError(f"{M} microbatches do not divide a batch of {B}")
    ex_w = (torch.ones(B) if plan is None
            else torch.as_tensor(plan.example_weights(B),
                                 dtype=torch.float32))
    noise_std = 0.0 if plan is None else plan.noise_std

    def loss_fn(params, batch, w):
        logits, aux = tfm.forward(params, batch, cfg)
        ce = _weighted_ce(text_logits(logits, cfg), batch["labels"], w)
        return ce + cfg.router_aux_weight * aux, ce

    def step(params, opt_state, batch, noise: Noise):
        leaves, treedef = tree_flatten(params)
        w = ex_w.to(batch["tokens"].device)
        if M == 1:
            (loss, ce), grads = value_and_grad(loss_fn, params, batch, w)
        else:
            gsum, ls, cs = None, [], []
            for m in range(M):
                part = {k: x.reshape((M, B // M) + x.shape[1:])[m]
                        for k, x in batch.items()}
                (l, c), g = value_and_grad(loss_fn, params, part,
                                           w.reshape(M, B // M)[m])
                if gsum is None:
                    gsum = [x.to(accum_dtype) for x in g]
                else:
                    for a, x in zip(gsum, g):
                        a.add_(x.to(accum_dtype))
                del g
                ls.append(l)
                cs.append(c)
            grads = [x.div_(M) for x in gsum]
            del gsum
            loss, ce = torch.stack(ls).mean(), torch.stack(cs).mean()
        if not donate:
            leaves = [p.clone() for p in leaves]
        opt_state = _apply_update(optimizer, leaves, grads, opt_state,
                                  noise, noise_std)
        out = params if donate else tree_unflatten(treedef, leaves)
        return out, opt_state, {"loss": loss, "ce": ce}

    return step


def _apply_update(optimizer, leaves, grads, opt_state, noise: Noise,
                  noise_std):
    """The shard step's tail, in place and leaf by leaf, so that at most
    one leaf's update is alive: g += σ·n
    (`repro_torch.dist.fl_integration.add_channel_noise`'s sum; n drawn
    here, in leaf order, when ``noise`` is a generator), then
    p += the optimizer's update of g (SGD's is leafwise).  Returns the
    new optimizer state."""
    if not isinstance(noise, torch.Generator) and len(noise) != len(leaves):
        raise ValueError(f"{len(noise)} noise tensors for {len(leaves)} "
                         f"leaves")
    noisy = not (isinstance(noise_std, (int, float)) and noise_std <= 0.0)
    new_state = opt_state
    for i, (p, g) in enumerate(zip(leaves, grads)):
        if noisy:
            n = (torch.randn(g.shape, generator=noise, dtype=g.dtype,
                             device=g.device)
                 if isinstance(noise, torch.Generator) else noise[i])
            g.add_(noise_std * n.to(g.dtype))
            del n
        (u,), new_state = optimizer.update([g], opt_state, [p])
        grads[i] = None
        del g
        p.add_(u.to(p.dtype))
        del u
    return new_state


def make_replica_train_step(cfg: ArchConfig, shape: InputShape,
                            plan: FLPlan, *, lr: float = 1e-3,
                            local_steps: int = 1):
    """Paper-faithful round: ``local_steps`` SGD steps a client, then
    Algorithm-1 CWFL aggregation across the stacked client axis.

    ``(stacked_params, batch, noise) -> (stacked_params, mean loss)``:
    every params leaf is (K, ...) f32, every batch leaf (K, B/K, ...);
    ``noise`` is the sync's ``(unit1, unit2)``, two (C, d) unit-normal
    matrices in the flat leaf order (`repro_torch.core.cwfl.aggregate`),
    or a ``torch.Generator`` to draw them from.  The K clients run one
    after another over views of the stacked tree (a ctypes kernel cannot
    run under ``torch.func.vmap``); the sync flattens the tree once into
    a (K, d) matrix for the fused round kernel."""
    K = plan.num_clients
    del shape   # the batch carries its own (K, B/K, S) shape

    def client_loss(params_k, batch_k):
        logits, aux = tfm.forward(params_k, batch_k, cfg)
        ce = torch.mean(token_cross_entropy(text_logits(logits, cfg),
                                            batch_k["labels"]))
        return ce + cfg.router_aux_weight * aux, ce

    def local_update(leaves_k, treedef, batch_k):
        losses = []
        for _ in range(local_steps):
            (loss, _), grads = value_and_grad(
                client_loss, tree_unflatten(treedef, leaves_k), batch_k)
            leaves_k = [p - lr * g.to(p.dtype)
                        for p, g in zip(leaves_k, grads)]
            losses.append(loss)
        return leaves_k, torch.stack(losses).mean()

    def step(stacked_params, batch, noise):
        leaves, treedef = tree_flatten(stacked_params)
        if leaves[0].shape[0] != K:
            raise ValueError(f"the plan has {K} clients, the params "
                             f"{leaves[0].shape[0]}")
        new = [torch.empty_like(x) for x in leaves]
        losses = []
        for k in range(K):
            leaves_k, loss = local_update(
                [x[k] for x in leaves], treedef,
                {name: x[k] for name, x in batch.items()})
            for out, x in zip(new, leaves_k):
                out[k] = x
            losses.append(loss)
        stacked = tree_unflatten(treedef, new)
        if isinstance(noise, torch.Generator):
            C, d = plan.num_clusters, tree_size(stacked) // K
            noise = tuple(torch.randn((C, d), generator=noise,
                                      device=leaves[0].device)
                          for _ in range(2))
        stacked, _ = cwfl_core.aggregate(stacked, plan.state, noise)
        return stacked, torch.stack(losses).mean()

    return step


def windowed_config(cfg: ArchConfig, window: Optional[int]) -> ArchConfig:
    """The serving-time sliding window (JAX's ``window_override``, the
    long_500k variants of full-attention configurations): every attention
    layer's window becomes ``min(window, its own)`` (its own 0: the
    override), every other mixer's 0.  ``None`` or 0: ``cfg`` as is."""
    if not window:
        return cfg
    pattern = tuple(
        dataclasses.replace(s, window=((min(s.window, window) or window)
                                       if s.mixer == "attn" else 0))
        for s in cfg.pattern)
    return cfg.replace(pattern=pattern)


def make_prefill_step(cfg: ArchConfig, shape: InputShape):
    """``(params, batch) -> (last_logits (B, 1, V), caches)``: the prompt
    (``shape.seq_len`` tokens, ``shape.global_batch`` rows) through the
    model.  JAX's builder also returns the arguments' shapes and the
    mesh's shardings; one card has neither."""
    del shape   # the batch carries its own (B, S)

    def step(params, batch):
        return tfm.prefill(params, batch, cfg)

    return step


def make_decode_step(cfg: ArchConfig, shape: InputShape,
                     window_override: Optional[int] = None,
                     replicate_cache_heads: bool = False):
    """``(params, token (B, 1), caches, pos, enc_kv=None) -> (logits (B, 1,
    V), deltas)``: one token against a ``shape.seq_len`` cache
    (`repro_torch.training.serve.pad_caches` of the windowed
    configuration, ``step.cfg``, lays a prefill's caches out for it).

    ``window_override``: `windowed_config`.  ``replicate_cache_heads``:
    JAX keeps the KV cache whole on every device of the model axis
    instead of split over its head dim; one card holds the whole cache
    already, so the step computes what the default step computes."""
    del shape, replicate_cache_heads
    run_cfg = windowed_config(cfg, window_override)

    def step(params, token, caches, pos, enc_kv=None):
        return tfm.decode_step(params, token, caches, pos, run_cfg,
                               enc_kv=enc_kv)

    step.cfg = run_cfg
    return step
