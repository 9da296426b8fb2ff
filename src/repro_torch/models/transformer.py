"""Model assembly: the dense attention decoder (port of
`repro.models.transformer`).

Layout as in the JAX package: ``cfg.pattern`` is a tuple of LayerSpecs
cycled ``num_periods`` times, and the parameters of pattern position i are
stacked over periods, ``params["layers"][f"b{i}"]`` with leaves of shape
(num_periods, ...), so `repro_torch.convert.params_from_jax` carries a JAX
tree across leaf for leaf.  The periods run as a Python loop (JAX scans
them).  Caches are stacked the same way: ``caches[f"b{i}"]["mixer"]["k"]``
is (num_periods, B, S, KV, hd).

Entry points:
  init_params(seed, cfg, device=None)
  forward(params, batch, cfg)                  -> (logits, aux)   [train]
  prefill(params, batch, cfg)                  -> (last_logits, caches)
  decode_step(params, token, caches, pos, cfg) -> (logits, deltas)
  count_params(cfg)

On the card every attention layer of ``forward`` and ``prefill`` launches
the hand-written flash-attention kernel
(`repro_torch.kernels.flash_attention`), and ``forward`` is differentiable:
under autograd each layer's backward launches the attention backward
kernel; decoding is plain torch
(`repro_torch.models.attention.decode_attention_delta`).  MoE, the mamba
and xLSTM mixers, the audio and vision front ends and cross-attention
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.attention import decode_attention_delta
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import (dense_init, norm, rope, softcap,
                                       swiglu, swiglu_init)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map

_LATER = "ROADMAP §1, other mixers and front ends"


def _require_dense(cfg: ArchConfig) -> None:
    """The port runs the dense attention decoder and nothing else yet."""
    if cfg.frontend != "none" or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} front end and cross-attention "
            f"are not ported yet ({_LATER})")
    if cfg.qk_norm:
        raise NotImplementedError(f"{cfg.name}: qk_norm comes with the MoE "
                                  f"configurations ({_LATER})")
    for spec in cfg.pattern:
        if spec.mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: the {spec.mixer} mixer "
                                      f"is not ported yet ({_LATER})")
        if spec.ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: MoE is not ported yet "
                                      f"({_LATER})")


# ---------------------------------------------------------------------------
# Attention sub-module.
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ArchConfig, device, lead: tuple = ()) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, H * hd, cfg.pdtype, device, lead),
        "wk": dense_init(gen, d, KV * hd, cfg.pdtype, device, lead),
        "wv": dense_init(gen, d, KV * hd, cfg.pdtype, device, lead),
        "wo": dense_init(gen, H * hd, d, cfg.pdtype, device, lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(*lead, width, dtype=cfg.pdtype,
                                  device=device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def self_attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    spec: LayerSpec, *, positions: torch.Tensor,
                    pos: Optional[int] = None, cache: Optional[dict] = None,
                    return_cache: bool = False):
    """Causal self-attention.  Train: ``cache=None``; prefill:
    ``return_cache=True`` (the layer's k, v); decode: ``cache = {k, v}``
    and ``pos``, the new token's position, as an int (the host's decode
    loop knows it; reading it from ``positions`` would stall the card at
    every layer).

    Decode is paged-style: the cache is READ-ONLY and does not hold the
    current token, whose k, v are merged through the softmax statistics
    and returned as a delta (``k_new``, ``v_new``) for the serving loop to
    write (`repro_torch.training.serve.apply_cache_deltas`)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        o = flash_attention_op(q, k, v, causal=True, window=spec.window,
                               cap=cfg.softcap_attn)
        new_cache = {"k": k, "v": v} if return_cache else None
    else:
        W = cache["k"].shape[1]
        if spec.window > 0 and W <= spec.window:
            # A ring buffer of the last W positions (the current one
            # excluded); the slot the loop overwrites next (pos % W, which
            # holds position pos − W) is already outside the window.
            idx = torch.arange(W, device=x.device)
            valid = (idx < pos) & (idx != pos % W)
            o = decode_attention_delta(q, cache["k"], cache["v"], k, v, pos,
                                       kv_valid=valid, cap=cfg.softcap_attn)
        else:
            o = decode_attention_delta(q, cache["k"], cache["v"], k, v, pos,
                                       window=spec.window,
                                       cap=cfg.softcap_attn)
        new_cache = {"k_new": k.to(cache["k"].dtype),
                     "v_new": v.to(cache["v"].dtype)}
    o = o.reshape(B, S, cfg.num_heads * cfg.hd)
    return o @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# Block = norm + attention + norm + ffn, pre-norm residual.
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ArchConfig, spec: LayerSpec, device,
               lead: tuple = ()) -> dict:
    d = cfg.d_model
    p = {"ln1": torch.zeros(*lead, d, dtype=torch.float32, device=device),
         "attn": attn_init(gen, cfg, device, lead)}
    if spec.ffn == "dense":
        p["ln2"] = torch.zeros(*lead, d, dtype=torch.float32, device=device)
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff, cfg.pdtype, device, lead)
    return p


def block_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                *, positions: torch.Tensor, pos: Optional[int] = None,
                cache: Optional[dict] = None, return_cache: bool = False):
    """Returns ``(x, new_cache)``; ``new_cache`` is None unless a cache was
    asked for or given."""
    h = norm(x, p["ln1"], cfg.norm)
    y, new_mixer = self_attn_apply(
        p["attn"], h, cfg, spec, positions=positions, pos=pos,
        cache=None if cache is None else cache["mixer"],
        return_cache=return_cache)
    x = x + y
    if spec.ffn == "dense":
        x = x + swiglu(p["ffn"], norm(x, p["ln2"], cfg.norm))
    return x, (None if new_mixer is None else {"mixer": new_mixer})


# ---------------------------------------------------------------------------
# Layer stack: a Python loop over periods.
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ArchConfig, device) -> dict:
    return {f"b{i}": block_init(gen, cfg, spec, device,
                                lead=(cfg.num_periods,))
            for i, spec in enumerate(cfg.pattern)}


def _put(out: dict, tree: dict, period: int, periods: int) -> None:
    """Write one period's cache tree into the stacked tree ``out``, whose
    leaves are allocated at the first period: no second copy of the
    stack is ever made."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _put(out.setdefault(name, {}), leaf, period, periods)
        else:
            if name not in out:
                out[name] = leaf.new_empty((periods,) + tuple(leaf.shape))
            out[name][period] = leaf


def stack_apply(layers: dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, pos: Optional[int] = None,
                caches: Optional[dict] = None, return_cache: bool = False):
    """Apply all layers.  ``caches``: the stacked cache tree (leading
    period axis per ``b{i}``).  Returns ``(x, new_caches)``."""
    new_caches: dict = {}
    for period in range(cfg.num_periods):
        for i, spec in enumerate(cfg.pattern):
            name = f"b{i}"
            cache = (None if caches is None else
                     tree_map(lambda a: a[period], caches[name]))
            x, nc = block_apply(
                tree_map(lambda a: a[period], layers[name]), x, cfg, spec,
                positions=positions, pos=pos, cache=cache,
                return_cache=return_cache)
            if nc is not None:
                _put(new_caches.setdefault(name, {}), nc, period,
                     cfg.num_periods)
    return x, (new_caches or None)


# ---------------------------------------------------------------------------
# Full model.
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ArchConfig, *, device=None) -> dict:
    """Random weights with the JAX package's distributions (embed N(0,1)
    ·d^-0.5, dense N(0,1)/√d_in, norm scales and biases 0), drawn on
    ``device`` from a generator seeded with ``seed``.  They are not JAX's
    draws: `repro_torch.convert.params_from_jax` carries those across.
    On the ``meta`` device nothing is allocated (`count_params`)."""
    _require_dense(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device).manual_seed(seed))
    d = cfg.d_model
    params = {
        "embed": torch.randn(cfg.vocab_size, d, generator=gen,
                             device=device).mul_(d ** -0.5).to(cfg.pdtype),
        "layers": stack_init(gen, cfg, device),
        "final_norm": torch.zeros(d, dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, cfg.pdtype,
                                       device)
    return params


def _embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig):
    return params["embed"].to(cfg.cdtype)[tokens]


def _lm_logits(params: dict, x: torch.Tensor, cfg: ArchConfig):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.cdtype)
    return softcap(x @ head, cfg.softcap_final)


def forward(params: dict, batch: dict, cfg: ArchConfig):
    """Training forward: full-sequence logits.  Returns ``(logits, aux)``;
    ``aux`` is the MoE router loss, 0 for the dense decoder."""
    _require_dense(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = stack_apply(params["layers"], x, cfg, positions=positions)
    x = norm(x, params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Prefill: forward over the prompt, returning the last position's
    logits (B, 1, V) and the full decode cache."""
    _require_dense(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, caches = stack_apply(params["layers"], x, cfg, positions=positions,
                            return_cache=True)
    x = norm(x[:, -1:], params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), caches


def decode_step(params: dict, token: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig):
    """One decode step.  token: (B, 1); ``pos``: the current write
    position (the number of tokens already in the cache).  Returns
    ``(logits (B, 1, V), deltas)``: each attention layer's new k, v,
    stacked as the caches are."""
    _require_dense(cfg)
    x = _embed_tokens(params, token, cfg)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    x, deltas = stack_apply(params["layers"], x, cfg, positions=positions,
                            pos=pos, caches=caches, return_cache=True)
    x = norm(x, params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), deltas


def count_params(cfg: ArchConfig) -> int:
    """Parameter count, from the shapes alone (the ``meta`` device)."""
    return sum(leaf.numel() for leaf in
               tree_leaves(init_params(0, cfg, device="meta")))
