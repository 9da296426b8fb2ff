"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly sequential), arXiv:2405.04517 (port of
`repro.models.xlstm`).

mLSTM recurrence (stabilized; stored state C̃ = C/exp(m)):
    m_t = max(logσ(f̃_t) + m_{t−1}, ĩ_t)
    C̃_t = exp(logσ(f̃_t)+m_{t−1}−m_t)·C̃_{t−1} + exp(ĩ_t−m_t)·k_t v_tᵀ
    ñ_t = … (the same, with k_t)
    h_t = C̃_tᵀ q_t / max(|ñ_tᵀ q_t|, exp(−m_t))

The chunkwise form computes, inside a chunk with carry (C̃₀, ñ₀, m₀):
    F_t = Σ_{s≤t} logσ(f̃_s),  a_s = ĩ_s − F_s,
    g_t = max(m₀, max_{s≤t} a_s),  m_t = F_t + g_t,
    intra weight w_{ts} = exp(a_s − g_t)·[s ≤ t],  inter scale exp(m₀ − g_t),
which is the recurrence unrolled; the chunks run as a Python loop, the
work inside one as (c × c) products.

sLSTM has per-head recurrent weights R·h_{t−1} in every gate, so it cannot
run in parallel over time: a Python loop over the tokens, a handful of
launches a token on the card (PERF.md counts them).  Both are plain torch
here, as they are ``jnp`` there; hand-written kernels are later work
(ROADMAP §2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm
from repro_torch.models.ssm import causal_conv

# The mLSTM's pads: a padded step adds nothing (input gate e^-1e30) and
# forgets nothing (forget gate σ(1e3) = 1); the empty state's m.
_NO_INPUT = -1e30
_NO_FORGET = 1e3


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d_model: int, num_heads: int, dtype, device,
               lead: tuple = (), proj_factor: int = 2) -> dict:
    d_up = proj_factor * d_model
    gate_bias = torch.cat([
        torch.zeros(num_heads, dtype=torch.float32, device=device),  # input
        3.0 + torch.arange(num_heads, dtype=torch.float32,
                           device=device)])                          # forget
    return {
        "up_proj": dense_init(gen, d_model, 2 * d_up, dtype, device, lead),
        "conv_w": torch.randn(*lead, 4, d_up, generator=gen,
                              device=device).div_(2.0).to(dtype),
        "conv_b": torch.zeros(*lead, d_up, dtype=dtype, device=device),
        "wq": dense_init(gen, d_up, d_up, dtype, device, lead),
        "wk": dense_init(gen, d_up, d_up, dtype, device, lead),
        "wv": dense_init(gen, d_up, d_up, dtype, device, lead),
        "w_gates": dense_init(gen, d_up, 2 * num_heads, torch.float32,
                              device, lead),
        "b_gates": gate_bias.expand(*lead, 2 * num_heads).clone(),
        "head_norm": torch.zeros(*lead, d_up, dtype=torch.float32,
                                 device=device),
        "down_proj": dense_init(gen, d_up, d_model, dtype, device, lead),
    }


def _mlstm_chunk(q, k, v, i_raw, lf, carry):
    """One chunk.  q, k, v: (B, c, nh, dh) f32; i_raw, lf: (B, c, nh);
    carry = (C: (B, nh, dk, dv), n: (B, nh, dk), m: (B, nh))."""
    C0, n0, m0 = carry
    F_ = torch.cumsum(lf, dim=1)                            # (B, c, nh)
    a = i_raw - F_
    g = torch.maximum(m0[:, None], torch.cummax(a, dim=1).values)
    m_t = F_ + g

    # intra-chunk: w[t, s] = exp(a_s − g_t) for s ≤ t.
    w = torch.exp(a[:, None, :, :] - g[:, :, None, :])      # (B, t, s, nh)
    c = w.shape[1]
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
    w = torch.where(tri[None, :, :, None], w, 0.0)
    qk = torch.einsum("bthd,bshd->btsh", q, k)
    num = torch.einsum("btsh,bshd->bthd", qk * w, v)
    den = torch.einsum("btsh,btsh->bth", qk, w)

    inter = torch.exp(m0[:, None] - g)                      # (B, c, nh)
    num = num + inter[..., None] * torch.einsum("bthd,bhde->bthe", q, C0)
    den = den + inter * torch.einsum("bthd,bhd->bth", q, n0)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # the chunk-end state
    g_end = g[:, -1]                                        # (B, nh)
    m_end = F_[:, -1] + g_end
    wk = torch.exp(a - g_end[:, None])                      # (B, c, nh)
    decay = torch.exp(m0 - g_end)
    C1 = decay[:, :, None, None] * C0 + torch.einsum(
        "bshd,bsh,bshe->bhde", k, wk, v)
    n1 = decay[:, :, None] * n0 + torch.einsum("bshd,bsh->bhd", k, wk)
    return h, (C1, n1, m_end)


def mlstm_cell(q, k, v, i_raw, f_raw, chunk: int, unroll: bool = False,
               state=None):
    """q, k, v: (B, S, nh, dh); gates (B, S, nh) f32.  Returns ``(h (B, S,
    nh, dh) f32, state)``; S is padded to a multiple of ``chunk`` with
    steps that change nothing, as in JAX.  ``unroll``: JAX's switch, a
    no-op (a Python loop either way)."""
    del unroll
    B, S, nh, dh = q.shape
    q = q * (dh ** -0.5)
    nchunks = -(-S // chunk)
    pad = nchunks * chunk - S
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=_NO_INPUT)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=_NO_FORGET)
    lf = F.logsigmoid(f_raw)
    if state is None:
        f32 = {"dtype": torch.float32, "device": q.device}
        state = (torch.zeros(B, nh, dh, dh, **f32),
                 torch.zeros(B, nh, dh, **f32),
                 torch.full((B, nh), _NO_INPUT, **f32))
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    hs = []
    for i in range(nchunks):
        part = slice(i * chunk, (i + 1) * chunk)
        h, state = _mlstm_chunk(q[:, part], k[:, part], v[:, part],
                                i_raw[:, part], lf[:, part], state)
        hs.append(h)
    h = torch.cat(hs, dim=1)
    return (h[:, :S] if pad else h), state


def mlstm_step(q, k, v, i_raw, f_raw, state):
    """The exact single-token recurrence (decode).  q, k, v: (B, nh, dh);
    gates (B, nh); state as in `mlstm_cell`."""
    C, n, m = state
    dh = q.shape[-1]
    q = q.to(torch.float32) * (dh ** -0.5)
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    f_eff = torch.exp(lf + m - m_new)
    i_eff = torch.exp(i_raw - m_new)
    C = f_eff[..., None, None] * C + i_eff[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_eff[..., None] * n + i_eff[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def mlstm_apply(params: dict, x: torch.Tensor, cfg, cache=None,
                unroll: bool = False):
    """The mLSTM block mixer.  x: (B, S, d_model); ``cache``: None or
    ``{conv, C, n, m}``; one token with a cache runs `mlstm_step`.
    Returns ``(y, new_cache)``."""
    B, S, _ = x.shape
    nh = cfg.num_heads
    up = x @ params["up_proj"]
    d_up = up.shape[-1] // 2
    xm, z = up[..., :d_up], up[..., d_up:]
    xc, new_conv = causal_conv(xm, params["conv_w"], params["conv_b"],
                               None if cache is None else cache["conv"])
    xc = F.silu(xc)
    dh = d_up // nh
    shp = (B, S, nh, dh)
    q = (xc @ params["wq"]).reshape(shp)
    k = (xc @ params["wk"]).reshape(shp)
    v = (xm @ params["wv"]).reshape(shp)
    gates = xc.to(torch.float32) @ params["w_gates"] + params["b_gates"]
    i_raw, f_raw = gates[..., :nh], gates[..., nh:]

    if cache is None:
        h, state = mlstm_cell(q, k, v, i_raw, f_raw, cfg.mlstm_chunk,
                              unroll=unroll)
    else:
        state = (cache["C"], cache["n"], cache["m"])
        if S == 1:
            h1, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                   f_raw[:, 0], state)
            h = h1[:, None]
        else:
            h, state = mlstm_cell(q, k, v, i_raw, f_raw, cfg.mlstm_chunk,
                                  unroll=unroll, state=state)

    h = h.reshape(B, S, d_up).to(x.dtype)
    h = rmsnorm(h.reshape(B, S, nh, dh),
                params["head_norm"].reshape(nh, dh)).reshape(B, S, d_up)
    out = (h * F.silu(z)) @ params["down_proj"]
    C, n, m = state
    return out, {"conv": new_conv, "C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d_model: int, num_heads: int, dtype, device,
               lead: tuple = ()) -> dict:
    dh = d_model // num_heads
    f32 = {"dtype": torch.float32, "device": device}
    bias = torch.cat([torch.zeros(2 * d_model, **f32),          # z, i
                      torch.full((d_model,), 3.0, **f32),       # f
                      torch.zeros(d_model, **f32)])             # o
    return {
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype, device, lead),
        "b_in": bias.expand(*lead, 4 * d_model).clone(),
        "r": torch.randn(*lead, 4, num_heads, dh, dh, generator=gen,
                         device=device).mul_(dh ** -0.5).to(dtype),
        "head_norm": torch.zeros(*lead, d_model, **f32),
        "out_proj": dense_init(gen, d_model, d_model, dtype, device, lead),
    }


def slstm_step(params: dict, xw: torch.Tensor, state, num_heads: int):
    """One token.  xw: x @ w_in + b for the step, (B, 4·d); state: (c, n,
    m, h), each (B, d).  Returns ``(h_out, state)``."""
    c, n, m, h = state
    B, d4 = xw.shape
    d = d4 // 4
    hh = h.reshape(B, num_heads, d // num_heads)
    rec = torch.einsum("bhd,ghde->gbhe", hh,
                       params["r"].to(torch.float32)).reshape(4, B, d)
    z_raw = xw[:, :d] + rec[0]
    i_raw = xw[:, d:2 * d] + rec[1]
    f_raw = xw[:, 2 * d:3 * d] + rec[2]
    o_raw = xw[:, 3 * d:] + rec[3]

    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    i_eff = torch.exp(i_raw - m_new)
    f_eff = torch.exp(lf + m - m_new)
    c = f_eff * c + i_eff * torch.tanh(z_raw)
    n = f_eff * n + i_eff
    h_new = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    return h_new, (c, n, m_new, h_new)


def slstm_apply(params: dict, x: torch.Tensor, cfg, cache=None,
                unroll: bool = False):
    """The sLSTM block mixer: a Python loop over the tokens.  x: (B, S,
    d).  Returns ``(y, {c, n, m, h})``."""
    del unroll
    B, S, d = x.shape
    nh = cfg.num_heads
    xw = (x.to(torch.float32) @ params["w_in"].to(torch.float32)
          + params["b_in"])                                  # (B, S, 4d)
    if cache is None:
        zeros = torch.zeros(B, d, dtype=torch.float32, device=x.device)
        state = (zeros, zeros, torch.full_like(zeros, _NO_INPUT), zeros)
    else:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    step_params = {"r": params["r"].to(torch.float32)}      # cast once
    hs = []
    for t in range(S):
        h, state = slstm_step(step_params, xw[:, t], state, nh)
        hs.append(h)
    h = torch.stack(hs, dim=1)                               # (B, S, d)
    h = rmsnorm(h.reshape(B, S, nh, d // nh),
                params["head_norm"].reshape(nh, d // nh)).reshape(B, S, d)
    out = h.to(x.dtype) @ params["out_proj"]
    c, n, m, hst = state
    return out, {"c": c, "n": n, "m": m, "h": hst}
