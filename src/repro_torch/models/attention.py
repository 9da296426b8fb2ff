"""GQA decode attention (port of `repro.models.attention`).

Prefill and training attention go through the port's Hopper kernel,
`repro_torch.kernels.ops.flash_attention_op` (the JAX package's cache-less
``flash_attention`` computes the same function).  Decoding one token
against the cache is plain torch here, as it is plain jnp there: the
scores of one query row are (B, H, S_cache), small beside the cache.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_delta(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, pos: int, *,
                           window: int = 0, cap: float = 0.0,
                           kv_valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Paged-style decode: the cache is READ-ONLY (it does not hold the new
    token); the new token's K/V are merged through online-softmax
    statistics, and the caller writes them into the cache afterwards.

    q: (B, 1, H, D); caches: (B, S, KV, D); k_new, v_new: (B, 1, KV, D);
    ``pos``: the new token's position, the number of tokens before it.
    ``kv_valid``: (S,) validity of the cache slots (default: the slots
    before ``pos``); ``window`` > 0 also drops slots at or below
    ``pos − window``.  Returns (B, 1, H, D) in q's dtype.
    """
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos < pos if kv_valid is None else kv_valid
    if window > 0:
        mask = mask & (k_pos > pos - window)

    qg = (q.to(torch.float32) * (D ** -0.5)).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    s = torch.where(mask, s, NEG_INF)
    m_c = torch.amax(s, dim=-1)                                  # (B, KV, G)
    p = torch.exp(s - m_c[..., None])
    l_c = torch.sum(p, dim=-1)
    out_c = (torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
             / torch.clamp(l_c, min=1e-30)[..., None]).to(q.dtype)

    # The new token's own score, merged into the cache's statistics.
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].to(torch.float32))
    if cap > 0.0:
        s_new = cap * torch.tanh(s_new / cap)
    m_f = torch.maximum(m_c, s_new)
    corr_c = torch.exp(m_c - m_f)
    p_new = torch.exp(s_new - m_f)
    l_f = l_c * corr_c + p_new
    num = (out_c.to(torch.float32) * (l_c * corr_c)[..., None]
           + p_new[..., None] * v_new[:, 0, :, None].to(torch.float32))
    out = num / torch.clamp(l_f, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
