"""Serving glue: cache capacity and a batched greedy decode loop (port of
`repro.training.serve`).

``pad_caches`` turns prefill caches (length = prompt) into fixed-capacity
decode caches:
  * full-attention layers: the time axis zero-padded to ``cache_len``;
  * sliding-window layers: the last W entries re-ordered into ring-buffer
    layout (slot j holds the newest position p ≡ j (mod W)).

``apply_cache_deltas`` writes each decode step's new k, v into the caches
IN PLACE (JAX writes a new cache with ``dynamic_update_slice``; the result
is the same, and at Gemma-2 9B's width an out-of-place write would copy
gigabytes of cache every step).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig


def _ring_order(S: int, W: int) -> np.ndarray:
    """Index map: ring slot j <- absolute position (newest p ≡ j mod W)."""
    j = np.arange(W)
    return S - 1 - ((S - 1 - j) % W)


def _pad_time_stacked(x: torch.Tensor, target: int) -> torch.Tensor:
    """x: (periods, B, S, ...) — zero-pad axis 2 to ``target``."""
    pad = target - x.shape[2]
    if pad <= 0:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 3) + (0, pad))


def pad_caches(caches: dict, cfg: ArchConfig, cache_len: int,
               prompt_len: int) -> dict:
    """Prefill caches -> decode caches of fixed capacity."""
    out = {}
    for i, spec in enumerate(cfg.pattern):
        c = caches[f"b{i}"]["mixer"]
        W = min(cache_len, spec.window) if spec.window > 0 else cache_len
        if spec.window > 0 and prompt_len >= W:
            idx = torch.as_tensor(_ring_order(prompt_len, W),
                                  device=c["k"].device)
            c = {"k": c["k"][:, :, idx], "v": c["v"][:, :, idx]}
        else:
            c = {"k": _pad_time_stacked(c["k"], W),
                 "v": _pad_time_stacked(c["v"], W)}
        out[f"b{i}"] = {"mixer": c}
    return out


def apply_cache_deltas(caches: dict, deltas: dict, pos: int,
                       cfg: ArchConfig) -> dict:
    """Write each attention layer's k, v delta (periods, B, 1, KV, hd) at
    ``pos`` (ring layers: ``pos % W``), in place; returns ``caches``."""
    for i, spec in enumerate(cfg.pattern):
        c = caches[f"b{i}"]["mixer"]
        d = deltas[f"b{i}"]["mixer"]
        W = c["k"].shape[2]                     # (periods, B, W, KV, hd)
        idx = pos % W if spec.window > 0 and W <= spec.window else pos
        c["k"][:, :, idx] = d["k_new"][:, :, 0]
        c["v"][:, :, idx] = d["v_new"][:, :, 0]
    return caches


def greedy_decode(params: dict, batch: dict, cfg: ArchConfig,
                  num_tokens: int, cache_len: Optional[int] = None):
    """Prefill the prompt, then greedily decode ``num_tokens`` tokens.
    Returns ``(tokens (B, num_tokens), last_logits (B, 1, V))``."""
    prompt_len = batch["tokens"].shape[1]
    cache_len = cache_len or (prompt_len + num_tokens)
    logits, caches = tfm.prefill(params, batch, cfg)
    caches = pad_caches(caches, cfg, cache_len, prompt_len)
    tokens = []
    for pos in range(prompt_len, prompt_len + num_tokens):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, deltas = tfm.decode_step(params, nxt, caches, pos, cfg)
        caches = apply_cache_deltas(caches, deltas, pos, cfg)
        tokens.append(nxt[:, 0])
    return torch.stack(tokens, dim=1), logits
