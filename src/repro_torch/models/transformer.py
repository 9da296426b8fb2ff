"""Model assembly: pattern-cycled blocks, encoder-decoder and VLM (port
of `repro.models.transformer`).

Layout as in the JAX package: ``cfg.pattern`` is a tuple of LayerSpecs
cycled ``num_periods`` times, and the parameters of pattern position i are
stacked over periods, ``params["layers"][f"b{i}"]`` with leaves of shape
(num_periods, ...), so `repro_torch.convert.params_from_jax` carries a JAX
tree across leaf for leaf.  The periods run as a Python loop (JAX scans
them).  Caches are stacked the same way: ``caches[f"b{i}"]["mixer"]`` holds
an attention layer's ``k``, ``v`` (num_periods, B, S, KV, hd), a mamba
layer's ``conv``, ``h``, an mLSTM's ``conv``, ``C``, ``n``, ``m`` and an
sLSTM's ``c``, ``n``, ``m``, ``h``.

A block is a pre-norm residual mixer (attention with optional qk_norm,
mamba, mLSTM or sLSTM), an optional cross-attention to the encoder (the
audio front end: its K/V computed once from block ``b0``'s period-0
``xattn`` and shared by every layer, as JAX's weight-shared
cross-attention does), and an FFN (SwiGLU, MoE, or none).  The vision
front end projects patch embeddings into ``prefix_tokens`` positions in
front of the text.

Entry points:
  init_params(seed, cfg, device=None)
  forward(params, batch, cfg)                  -> (logits, aux)   [train]
  prefill(params, batch, cfg)                  -> (last_logits, caches)
  decode_step(params, token, caches, pos, cfg, enc_kv=None)
                                               -> (logits, deltas)
  count_params(cfg), count_active_params(cfg)

``aux`` is the routers' load-balance loss summed over the MoE layers (0
without MoE).  On the card every attention of ``forward`` and ``prefill``
(self, the encoder's, cross) launches the hand-written flash-attention
kernel (`repro_torch.kernels.flash_attention`), and so does a decode
step's cross-attention; ``forward`` is differentiable: under autograd
each attention's backward launches the attention backward kernel.
Decode self-attention is plain torch
(`repro_torch.models.attention.decode_attention_delta`), and so are the
MoE dispatch, the selective scan and the xLSTM cells (`models/moe.py`,
`models/ssm.py`, `models/xlstm.py`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.attention import decode_attention_delta
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import (dense_init, norm, rmsnorm, rope,
                                       softcap, swiglu, swiglu_init)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import mamba_apply, mamba_init
from repro_torch.models.xlstm import (mlstm_apply, mlstm_init, slstm_apply,
                                      slstm_init)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Attention sub-module.
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ArchConfig, device, lead: tuple = (),
              cross: bool = False) -> dict:
    """q, k, v, o projections; the QKV biases and the qk_norm scales ((hd,)
    f32 zeros) where the configuration has them, never for
    cross-attention."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, H * hd, cfg.pdtype, device, lead),
        "wk": dense_init(gen, d, KV * hd, cfg.pdtype, device, lead),
        "wv": dense_init(gen, d, KV * hd, cfg.pdtype, device, lead),
        "wo": dense_init(gen, H * hd, d, cfg.pdtype, device, lead),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(*lead, width, dtype=cfg.pdtype,
                                  device=device)
    if cfg.qk_norm and not cross:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.zeros(*lead, hd, dtype=torch.float32,
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
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    if "q_norm" in p:                     # before RoPE, as in JAX
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def self_attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    spec: LayerSpec, *, positions: torch.Tensor,
                    pos: Optional[int] = None, cache: Optional[dict] = None,
                    causal: bool = True, return_cache: bool = False):
    """Self-attention (causal unless told otherwise: the audio encoder's is
    bidirectional).  Train: ``cache=None``; prefill: ``return_cache=True``
    (the layer's k, v); decode: ``cache = {k, v}`` and ``pos``, the new
    token's position, as an int (the host's decode loop knows it; reading
    it from ``positions`` would stall the card at every layer).

    Decode is paged-style: the cache is READ-ONLY and does not hold the
    current token, whose k, v are merged through the softmax statistics
    and returned as a delta (``k_new``, ``v_new``) for the serving loop to
    write (`repro_torch.training.serve.apply_cache_deltas`)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        o = flash_attention_op(q, k, v, causal=causal, window=spec.window,
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


def cross_attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
                     enc_kv: dict) -> torch.Tensor:
    """Cross-attention to the encoder's precomputed K/V (the whisper
    decoder): no mask, no RoPE, no softcap; through the flash kernel at
    any query count, one in decode."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.hd)
    o = flash_attention_op(q, enc_kv["k"], enc_kv["v"], causal=False)
    return o.reshape(B, S, cfg.num_heads * cfg.hd) @ p["wo"]


def encoder_kv(p: dict, enc_out: torch.Tensor, cfg: ArchConfig) -> dict:
    """Cross-attention K/V from the encoder's output (B, T, d)."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.num_kv_heads, cfg.hd)
    return {"k": (enc_out @ p["wk"]).reshape(shape),
            "v": (enc_out @ p["wv"]).reshape(shape)}


# ---------------------------------------------------------------------------
# Block = norm + mixer (+ cross-attention) (+ norm + ffn), pre-norm residual.
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ArchConfig, spec: LayerSpec, device,
               lead: tuple = (), cross: bool = False) -> dict:
    d = cfg.d_model

    def scale():
        return torch.zeros(*lead, d, dtype=torch.float32, device=device)

    p = {"ln1": scale()}
    if spec.mixer == "attn":
        p["attn"] = attn_init(gen, cfg, device, lead)
    elif spec.mixer == "mamba":
        p["mamba"] = mamba_init(gen, d, cfg.d_inner, cfg.ssm_state,
                                cfg.ssm_conv, cfg.dt_rank, cfg.pdtype,
                                device, lead)
    elif spec.mixer == "mlstm":
        p["mlstm"] = mlstm_init(gen, d, cfg.num_heads, cfg.pdtype, device,
                                lead)
    elif spec.mixer == "slstm":
        p["slstm"] = slstm_init(gen, d, cfg.num_heads, cfg.pdtype, device,
                                lead)
    else:
        raise ValueError(f"unknown mixer {spec.mixer}")
    if cross:
        p["ln_x"] = scale()
        p["xattn"] = attn_init(gen, cfg, device, lead, cross=True)
    if spec.ffn == "dense":
        p["ln2"] = scale()
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff, cfg.pdtype, device, lead)
    elif spec.ffn == "moe":
        p["ln2"] = scale()
        p["moe"] = moe_init(gen, d, cfg.d_ff_expert, cfg.num_experts,
                            cfg.pdtype, device, lead)
    return p


_RECURRENT = {"mamba": mamba_apply, "mlstm": mlstm_apply,
              "slstm": slstm_apply}


def block_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                *, positions: torch.Tensor, pos: Optional[int] = None,
                cache: Optional[dict] = None, enc_kv: Optional[dict] = None,
                return_cache: bool = False):
    """Returns ``(x, new_cache, aux)``: ``new_cache`` is None unless a
    cache was asked for or given; ``aux`` the MoE router's loss (0.)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm(x, p["ln1"], cfg.norm)
    mixer_cache = None if cache is None else cache["mixer"]
    if spec.mixer == "attn":
        y, new_mixer = self_attn_apply(
            p["attn"], h, cfg, spec, positions=positions, pos=pos,
            cache=mixer_cache, return_cache=return_cache)
    else:
        y, new_mixer = _RECURRENT[spec.mixer](p[spec.mixer], h, cfg,
                                              mixer_cache)
        if not return_cache and cache is None:
            new_mixer = None
    x = x + y

    if enc_kv is not None and "xattn" in p:
        x = x + cross_attn_apply(p["xattn"], norm(x, p["ln_x"], cfg.norm),
                                 cfg, enc_kv)

    if spec.ffn == "dense":
        x = x + swiglu(p["ffn"], norm(x, p["ln2"], cfg.norm))
    elif spec.ffn == "moe":
        h = norm(x, p["ln2"], cfg.norm)
        B, S, d = h.shape
        y, aux = moe_apply(p["moe"], h.reshape(B * S, d), top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           shards=cfg.moe_shards)
        x = x + y.reshape(B, S, d)
    return x, (None if new_mixer is None else {"mixer": new_mixer}), aux


# ---------------------------------------------------------------------------
# Layer stack: a Python loop over periods.
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ArchConfig, device, cross: bool = False) -> dict:
    return {f"b{i}": block_init(gen, cfg, spec, device,
                                lead=(cfg.num_periods,), cross=cross)
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
                caches: Optional[dict] = None, enc_kv: Optional[dict] = None,
                return_cache: bool = False):
    """Apply all layers.  ``caches``: the stacked cache tree (leading
    period axis per ``b{i}``).  Returns ``(x, new_caches, aux)``, ``aux``
    summed over the layers."""
    new_caches: dict = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for period in range(cfg.num_periods):
        for i, spec in enumerate(cfg.pattern):
            name = f"b{i}"
            cache = (None if caches is None else
                     tree_map(lambda a: a[period], caches[name]))
            x, nc, aux_i = block_apply(
                tree_map(lambda a: a[period], layers[name]), x, cfg, spec,
                positions=positions, pos=pos, cache=cache, enc_kv=enc_kv,
                return_cache=return_cache)
            aux = aux + aux_i
            if nc is not None:
                _put(new_caches.setdefault(name, {}), nc, period,
                     cfg.num_periods)
    return x, (new_caches or None), aux


# ---------------------------------------------------------------------------
# Full model.
# ---------------------------------------------------------------------------

def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The audio encoder: ``encoder_layers`` dense attention blocks."""
    return cfg.replace(num_layers=cfg.encoder_layers,
                       pattern=(LayerSpec("attn", 0, "dense"),))


def init_params(seed: int, cfg: ArchConfig, *, device=None) -> dict:
    """Random weights with the JAX package's distributions (embed N(0,1)
    ·d^-0.5, dense N(0,1)/√d_in, norm scales and biases 0, the mixers'
    own), drawn on ``device`` from a generator seeded with ``seed``.  They
    are not JAX's draws: `repro_torch.convert.params_from_jax` carries
    those across.  On the ``meta`` device nothing is allocated
    (`count_params`)."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device).manual_seed(seed))
    d = cfg.d_model
    params = {
        "embed": torch.randn(cfg.vocab_size, d, generator=gen,
                             device=device).mul_(d ** -0.5).to(cfg.pdtype),
        "layers": stack_init(gen, cfg, device,
                             cross=cfg.encoder_layers > 0),
        "final_norm": torch.zeros(d, dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, cfg.pdtype,
                                       device)
    if cfg.frontend == "vision_stub":
        params["projector"] = {
            "w1": dense_init(gen, cfg.frontend_dim, d, cfg.pdtype, device),
            "w2": dense_init(gen, d, d, cfg.pdtype, device)}
    if cfg.frontend == "audio_stub":
        params["encoder"] = {
            "in_proj": dense_init(gen, cfg.frontend_dim, d, cfg.pdtype,
                                  device),
            "layers": stack_init(gen, _encoder_cfg(cfg), device),
            "final_norm": torch.zeros(d, dtype=torch.float32,
                                      device=device)}
    return params


def _frontend_prefix(params: dict, batch: dict, cfg: ArchConfig):
    """VLM: the patch embeddings projected into d_model prefix tokens
    (``jax.nn.gelu``'s default is the tanh approximation)."""
    pe = batch["patch_embeds"].to(cfg.cdtype)
    h = F.gelu(pe @ params["projector"]["w1"], approximate="tanh")
    return h @ params["projector"]["w2"]


def _encode_audio(params: dict, batch: dict, cfg: ArchConfig):
    """The whisper encoder over the stub's frame embeddings (B, T_enc,
    frontend_dim): bidirectional attention blocks."""
    enc = params["encoder"]
    enc_cfg = _encoder_cfg(cfg)
    spec = enc_cfg.pattern[0]
    h = batch["frames"].to(cfg.cdtype) @ enc["in_proj"]
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for period in range(enc_cfg.num_periods):
        p = tree_map(lambda a: a[period], enc["layers"]["b0"])
        y, _ = self_attn_apply(p["attn"], norm(h, p["ln1"], cfg.norm),
                               enc_cfg, spec, positions=positions,
                               causal=False)
        h = h + y
        h = h + swiglu(p["ffn"], norm(h, p["ln2"], cfg.norm))
    return norm(h, enc["final_norm"], cfg.norm)


def _embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig):
    return params["embed"].to(cfg.cdtype)[tokens]


def _lm_logits(params: dict, x: torch.Tensor, cfg: ArchConfig):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.cdtype)
    return softcap(x @ head, cfg.softcap_final)


def _first_cross_params(params: dict, cfg: ArchConfig) -> dict:
    """Block ``b0``'s period-0 cross-attention: its K/V projections make
    the encoder K/V that every layer shares (JAX's weight-shared
    cross-attention, not Whisper's per-layer K/V)."""
    return tree_map(lambda a: a[0], params["layers"]["b0"]["xattn"])


def _assemble_inputs(params: dict, batch: dict, cfg: ArchConfig):
    """Token embeddings (behind the VLM prefix), and the encoder's K/V for
    the audio front end (else None)."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    enc_kv = None
    if cfg.frontend == "vision_stub":
        prefix = _frontend_prefix(params, batch, cfg)
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    if cfg.frontend == "audio_stub":
        enc_kv = encoder_kv(_first_cross_params(params, cfg),
                            _encode_audio(params, batch, cfg), cfg)
    return x, enc_kv


def forward(params: dict, batch: dict, cfg: ArchConfig):
    """Training forward: full-sequence logits.  Returns ``(logits,
    aux)``; ``aux`` is the MoE routers' loss summed over the layers."""
    x, enc_kv = _assemble_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = stack_apply(params["layers"], x, cfg, positions=positions,
                            enc_kv=enc_kv)
    x = norm(x, params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), aux


def prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Prefill: forward over the prompt (the VLM prefix included),
    returning the last position's logits (B, 1, V) and the full decode
    cache."""
    x, enc_kv = _assemble_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, caches, _ = stack_apply(params["layers"], x, cfg,
                               positions=positions, enc_kv=enc_kv,
                               return_cache=True)
    x = norm(x[:, -1:], params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), caches


def decode_step(params: dict, token: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig, enc_kv: Optional[dict] = None):
    """One decode step.  token: (B, 1); ``pos``: the current write
    position (the number of positions already in the cache);
    ``enc_kv``: the encoder's K/V (audio front end).  Returns ``(logits
    (B, 1, V), deltas)``: each attention layer's new k, v, and each
    recurrent layer's whole new state, stacked as the caches are."""
    x = _embed_tokens(params, token, cfg)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    x, deltas, _ = stack_apply(params["layers"], x, cfg, positions=positions,
                               pos=pos, caches=caches, enc_kv=enc_kv,
                               return_cache=True)
    x = norm(x, params["final_norm"], cfg.norm)
    return _lm_logits(params, x, cfg), deltas


def count_params(cfg: ArchConfig) -> int:
    """Parameter count, from the shapes alone (the ``meta`` device)."""
    return sum(leaf.numel() for leaf in
               tree_leaves(init_params(0, cfg, device="meta")))


def _expert_params(tree: dict, under_moe: bool = False) -> int:
    """Elements of the expert weights (``w_gate``, ``w_up``, ``w_down``
    under a ``moe`` key)."""
    n = 0
    for key, sub in tree.items():
        if isinstance(sub, dict):
            n += _expert_params(sub, under_moe or key == "moe")
        elif under_moe and key in ("w_gate", "w_up", "w_down"):
            n += sub.numel()
    return n


def count_active_params(cfg: ArchConfig) -> int:
    """Parameters a token uses: MoE expert weights count at top_k /
    num_experts."""
    total = count_params(cfg)
    if cfg.num_experts == 0:
        return total
    expert = _expert_params(init_params(0, cfg, device="meta"))
    return total - expert + expert * cfg.top_k // max(cfg.num_experts, 1)
