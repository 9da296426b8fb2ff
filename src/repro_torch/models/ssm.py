"""Mamba-style selective SSM (S6) with a chunked scan (port of
`repro.models.ssm`).

The sequence is cut into chunks, run one after another with the state
carried between them, and scanned inside a chunk in log2(chunk) doubling
steps over the discretized transitions (dA, dBu) with JAX's combine
(a1·a2, a2·b1 + b2): transient memory is O(B · chunk · d_inner · d_state)
and a chunk takes a few dozen launches, not one a step.  (torch has no
``associative_scan``; the doubling scan combines in another order than
JAX's, equal up to rounding.)  Padded steps are identity transitions
(dA = 1, dBu = 0), so they cannot decay the carried state.  The products
and the scan are plain torch here, as they are ``jnp`` there; a
hand-written selective-scan kernel is later work (ROADMAP §2).

Under autograd each chunk is checkpointed: the backward rescans it from
its input and the state carried into it, so training keeps two small
tensors a chunk instead of every doubling step's.

Decode runs the same code on one token: a chunk of one step, the exact
recurrence (JAX pads that token to a chunk of identity steps: equal up to
rounding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init


def mamba_init(gen, d_model: int, d_inner: int, d_state: int, d_conv: int,
               dt_rank: int, dtype, device, lead: tuple = ()) -> dict:
    """JAX's ``mamba_init`` distributions: S4D-real A (A_log = log n),
    dt_bias = softplus⁻¹(dt) for dt ~ U[1e-3, 0.1], D = 1."""
    def f32(*shape):
        return torch.empty(*lead, *shape, dtype=torch.float32, device=device)

    dt = f32(d_inner)
    if gen is not None:
        dt.uniform_(1e-3, 1e-1, generator=gen)
    conv_w = torch.randn(*lead, d_conv, d_inner, generator=gen,
                         device=device).mul_(d_conv ** -0.5).to(dtype)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_inner, dtype, device, lead),
        "conv_w": conv_w,
        "conv_b": torch.zeros(*lead, d_inner, dtype=dtype, device=device),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * d_state, dtype,
                             device, lead),
        "dt_proj": dense_init(gen, dt_rank, d_inner, dtype, device, lead),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(a).expand(*lead, d_inner, d_state).clone(),
        "D": torch.ones(*lead, d_inner, dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, d_inner, d_model, dtype, device, lead),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + eˣ) with no threshold (``F.softplus``
    turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_coeffs(params: dict, xz: torch.Tensor, d_state: int, dt_rank: int,
                valid: torch.Tensor | None = None):
    """Per-token discretized coefficients from the post-conv activations.

    xz: (B, L, d_inner) -> dA: (B, L, d_inner, N) f32, dBu: the same, C:
    (B, L, N) f32.  ``valid``: optional (L,) bool; a padded step gets the
    identity transition (dA = 1, dBu = 0)."""
    proj = xz @ params["x_proj"]                            # (B, L, r + 2N)
    dt_raw = proj[..., :dt_rank]
    Bc = proj[..., dt_rank:dt_rank + d_state].to(torch.float32)
    Cc = proj[..., dt_rank + d_state:].to(torch.float32)
    dt = softplus((dt_raw @ params["dt_proj"]).to(torch.float32)
                  + params["dt_bias"])
    if valid is not None:
        dt = dt * valid[None, :, None]
    A = -torch.exp(params["A_log"])                         # (d_inner, N)
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * xz.to(torch.float32))[..., None] * Bc[..., None, :]
    return dA, dBu, Cc


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h ↦ a·h + b (the
    prefix compositions: A_cum, B_cum), in log2(len) doubling steps."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def selective_scan(params: dict, xz: torch.Tensor, d_state: int,
                   dt_rank: int, chunk: int, unroll: bool = False,
                   h0: torch.Tensor | None = None):
    """Chunked selective scan.  xz: (B, L, d_inner), after the conv and
    its activation.  Returns ``(y (B, L, d_inner) f32, h_final (B,
    d_inner, N) f32)``.  A sequence shorter than ``chunk`` runs as one
    chunk of its own length (JAX pads it to ``chunk`` with identity
    steps: the same state and outputs up to rounding); ``unroll`` is
    JAX's cost-measurement switch, a no-op here (the chunks are a Python
    loop either way)."""
    del unroll
    B, L, d_inner = xz.shape
    chunk = min(chunk, L)
    nchunks = -(-L // chunk)
    pad = nchunks * chunk - L
    if pad:
        xz = F.pad(xz, (0, 0, 0, pad))
        valid = (torch.arange(nchunks * chunk, device=xz.device) < L
                 ).reshape(nchunks, chunk)
    h = (torch.zeros(B, d_inner, d_state, dtype=torch.float32,
                     device=xz.device) if h0 is None else h0)
    # Under autograd each chunk is recomputed in the backward from its
    # input and carried state (``torch.utils.checkpoint``): the doubling
    # steps' (B, chunk, d_inner, N) tensors are never kept for a whole
    # sequence, only a chunk's at a time.  Serving runs the chunks as is.
    recompute = torch.is_grad_enabled() and (
        xz.requires_grad or h.requires_grad
        or any(p.requires_grad for p in params.values()))
    ys = []
    for i in range(nchunks):
        xc = xz[:, i * chunk:(i + 1) * chunk]
        v = valid[i] if pad else None
        if recompute:
            y, h = checkpoint(_scan_chunk, params, xc, h, d_state, dt_rank,
                              v, use_reentrant=False)
        else:
            y, h = _scan_chunk(params, xc, h, d_state, dt_rank, v)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return (y[:, :L] if pad else y), h


def _scan_chunk(params: dict, xc: torch.Tensor, h: torch.Tensor,
                d_state: int, dt_rank: int, valid):
    """One chunk of the selective scan from the carried state h: ``(y (B,
    c, d_inner) f32, h at the chunk's last step)``."""
    dA, dBu, Cc = _ssm_coeffs(params, xc, d_state, dt_rank, valid=valid)
    A_cum, B_cum = _scan(dA, dBu)
    del dA, dBu
    h_t = A_cum * h[:, None] + B_cum                    # (B, c, d_inner, N)
    del A_cum, B_cum
    y = torch.einsum("bcdn,bcn->bcd", h_t, Cc)
    return y + params["D"] * xc.to(torch.float32), h_t[:, -1]


def causal_conv(xz: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                conv_state: torch.Tensor | None = None):
    """Depthwise causal conv over time.  xz: (B, L, d); kernel (K, d);
    ``conv_state``: the K − 1 inputs before xz (zeros if None).  Returns
    ``(out, new_state)``, the state the last K − 1 inputs."""
    K = conv_w.shape[0]
    if conv_state is None:
        pad = xz.new_zeros(xz.shape[0], K - 1, xz.shape[2])
    else:
        pad = conv_state.to(xz.dtype)
    xp = torch.cat([pad, xz], dim=1)                     # (B, L + K − 1, d)
    L = xz.shape[1]
    out = sum(xp[:, i:i + L] * conv_w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out + conv_b, new_state


def mamba_apply(params: dict, x: torch.Tensor, cfg, cache=None,
                unroll: bool = False):
    """The Mamba block mixer.  x: (B, L, d_model); ``cache``: None, or
    ``{conv: (B, K − 1, d_inner), h: (B, d_inner, N) f32}`` to continue
    from.  Returns ``(y (B, L, d_model), new_cache)``."""
    d_inner = cfg.d_inner
    xz_in = x @ params["in_proj"]                        # (B, L, 2·d_inner)
    xin, z = xz_in[..., :d_inner], xz_in[..., d_inner:]
    xc, new_conv = causal_conv(xin, params["conv_w"], params["conv_b"],
                               None if cache is None else cache["conv"])
    xc = F.silu(xc)
    y, h = selective_scan(params, xc, cfg.ssm_state, cfg.dt_rank,
                          cfg.ssm_chunk, unroll=unroll,
                          h0=None if cache is None else cache["h"])
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], {"conv": new_conv, "h": h}

