"""The arithmetic of the attention backward kernels
(``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``), emulated on the
CPU and held against the plain backward and ``jax.vjp`` of the JAX
package's chunked attention (``repro.models.attention.flash_attention``,
which the JAX package trains through), at ``chip_smoke.py``'s small
``BWD_SHAPES`` entries (S = 130, G = 3, window 40, cap 50, D 32 to 256)
and the same shapes causal at cap 0, within its ``BWD_TOL``.

f32 (3×TF32): every operand split into TF32 halves by bit masks (hi = the
f32 rounded to TF32, ties away from zero; lo = TF32 of the rest); S and dP
as hi·hi plus the two correction passes summed apart; dK and dV built
from one head's 32-query tiles at a time (each tile's product from zero,
added in f32), the G heads' partials added in the order g = 0, 1, ...;
dQ from 64-key tiles (32 at D = 256) the same way.  bf16: products of
the bf16 inputs summed in f32, P and dS rounded to bf16 once before dV,
dK and dQ, the gradients rounded to bf16.  A single TF32 pass misses the
f32 tolerance.  This checks the accuracy argument of the kernels'
design, not the kernels: the tensor cores' own accumulation is not
emulated.  Alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_flash_bwd_arith.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jax_model_fa
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BWD_TOL = chip_smoke.BWD_TOL
SMALL = [s for s in chip_smoke.BWD_SHAPES if s[0].startswith("small")]
CASES = SMALL + [(f"{s[0]}_causal", *s[1:7], 0, 0.0) for s in SMALL]
BK = 64                 # keys a dK/dV block, keys a dQ tile (f32 D = 256: 32)
BQ_KV = {torch.float32: 32, torch.bfloat16: 64}   # queries a dK/dV tile
BQ_Q = 64               # query rows a dQ tile (a warpgroup's)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 kept in f32: round to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def nt(a, b, passes: int):
    """a @ b.T as S and dP: hi·hi and the correction passes summed apart
    (passes 3), or hi·hi alone (passes 1)."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = ah @ bh.T
    return out + (ah @ bl.T + al @ bh.T) if passes == 3 else out


def nn(a, b, passes: int):
    """a @ b from zero, as one tile's piece of dK, dV or dQ."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = ah @ bh
    return out + al @ bh + ah @ bl if passes == 3 else out


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate(q, k, v, o, lse, do, *, causal, window, cap, scale,
            passes: int = 3):
    """The kernels' gradient with their arithmetic, tile by tile: q, o, do
    (B, H, Sq, D), k, v (B, KV, Skv, D) and lse (B, H, Sq), all f32 or
    all bf16; returns (dq, dk, dv) in the inputs' dtype."""
    dtype = q.dtype
    f32 = torch.float32
    is_bf16 = dtype == torch.bfloat16
    q, k, v, o, do = (x.to(f32) for x in (q, k, v, o, do))
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    delta = (do * o).sum(-1)
    # bf16: q as it is, the scale on the f32 scores and on dK and dQ at the
    # end; f32: the split pass's q * scale.
    qk = q if is_bf16 else q * scale
    s_mul = scale if is_bf16 else 1.0

    def scores(a, b):
        return (a @ b.T) * s_mul if is_bf16 else nt(a, b, passes)

    def grad(a, b):
        return bf16(a) @ b if is_bf16 else nn(a, b, passes)

    def prob(s, lse_rows, m):
        dt = 1.0
        if cap > 0.0:
            t = torch.tanh(s / cap)
            s, dt = cap * t, 1.0 - t * t
        return torch.where(m, torch.exp(s - lse_rows), 0.0), dt

    part_k = torch.zeros(G, B, KV, Skv, D)
    part_v = torch.zeros(G, B, KV, Skv, D)
    bq = BQ_KV[dtype]
    for b in range(B):
        for kvh in range(KV):
            for g in range(G):
                h = kvh * G + g
                for k0 in range(0, Skv, BK):
                    keys = slice(k0, min(k0 + BK, Skv))
                    kk, vv = k[b, kvh, keys], v[b, kvh, keys]
                    kmax = keys.stop - 1
                    i_begin = k0 if causal else 0
                    i_end = min(Sq, kmax + window) if window > 0 else Sq
                    acc_k = torch.zeros(keys.stop - k0, D)
                    acc_v = torch.zeros(keys.stop - k0, D)
                    for i0 in range(i_begin, i_end, bq):
                        rows = slice(i0, min(i0 + bq, Sq))
                        st = scores(kk, qk[b, h, rows])
                        p, dt = prob(st, lse[b, h, rows][None, :],
                                     mask[rows, keys].T)
                        dpt = scores(vv, do[b, h, rows]) / s_mul
                        dst = p * dt * (dpt - delta[b, h, rows][None, :])
                        acc_v += grad(p, do[b, h, rows])
                        acc_k += grad(dst, qk[b, h, rows])
                    part_k[g, b, kvh, keys] = acc_k * s_mul
                    part_v[g, b, kvh, keys] = acc_v
    dk, dv = part_k[0], part_v[0]
    for g in range(1, G):
        dk, dv = dk + part_k[g], dv + part_v[g]

    dq = torch.zeros(B, H, Sq, D)
    tk = BK if is_bf16 or D < 256 else BK // 2
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, Sq, BQ_Q):
                rows = slice(q0, min(q0 + BQ_Q, Sq))
                k_end = min(Skv, q0 + BQ_Q, Sq) if causal else Skv
                k_begin = max(0, q0 - window + 1) // tk * tk if window else 0
                acc = torch.zeros(rows.stop - q0, D)
                for k0 in range(k_begin, k_end, tk):
                    keys = slice(k0, min(k0 + tk, Skv))
                    kk, vv = k[b, kvh, keys], v[b, kvh, keys]
                    s = scores(qk[b, h, rows], kk)
                    p, dt = prob(s, lse[b, h, rows][:, None],
                                 mask[rows, keys])
                    dp = scores(do[b, h, rows], vv) / s_mul
                    ds = p * dt * (dp - delta[b, h, rows][:, None])
                    acc += grad(ds, kk)
                dq[b, h, rows] = acc * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _inputs(B, H, KV, S, D, dtype, seed):
    """chip_smoke's inputs in distribution (q scaled by 4 so that the
    scores reach past ±15 and the softcap bends them), drawn with numpy
    and rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [(4.0 if i == 0 else 1.0) * rng.standard_normal(s)
            .astype(np.float32)
            for i, s in enumerate([(B, H, S, D), (B, KV, S, D),
                                   (B, KV, S, D), (B, H, S, D)])]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _rel(got, want) -> float:
    """The largest error over the largest magnitude, in f32."""
    got, want = (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_grads(q, k, v, do, *, causal, window, cap, scale):
    """``jax.vjp`` of the JAX model's chunked attention (layout (B, S,
    heads, D); it scales q by D^-0.5 itself) on the same inputs, in (B,
    heads, S, D)."""
    assert scale == q.shape[3] ** -0.5
    dtype = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def to_jax(x):
        return jnp.asarray(x.to(torch.float32).numpy()).astype(
            dtype).transpose(0, 2, 1, 3)

    def fn(qj, kj, vj):
        return jax_model_fa(qj, kj, vj, causal=causal, window=window,
                            cap=cap)

    _, vjp = jax.vjp(fn, to_jax(q), to_jax(k), to_jax(v))
    return [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for g in vjp(to_jax(do))]


def _case(label, B, H, KV, S, D, dtype, window, cap):
    q, k, v, do = _inputs(B, H, KV, S, D, dtype, seed=S + D + window + 1)
    mode = {"causal": True, "window": window, "cap": cap,
            "scale": D ** -0.5}
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **mode)
    return (q, k, v, o, lse, do), mode


@pytest.mark.parametrize("label,B,H,KV,S,D,dtype,window,cap", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_backward_meets_bwd_tol(label, B, H, KV, S, D, dtype,
                                         window, cap):
    """The emulated kernel against the plain backward on the same o and
    lse, and against jax.vjp of JAX's chunked attention, within
    BWD_TOL[dtype] of each gradient's largest magnitude."""
    args, mode = _case(label, B, H, KV, S, D, dtype, window, cap)
    got = emulate(*args, **mode)
    want = flash_attention_bwd_ref(*args, **mode)
    q, k, v, _, _, do = args
    want_jax = _jax_grads(q, k, v, do, **mode)
    tol = BWD_TOL[dtype]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want_jax):
        assert _rel(a, b) <= tol, (name, _rel(a, b))
        assert _rel(a, c) <= tol, (name, _rel(a, c))


F32_SMALL = [c for c in CASES if c[6] == torch.float32]


@pytest.mark.parametrize("label,B,H,KV,S,D,dtype,window,cap", F32_SMALL,
                         ids=[c[0] for c in F32_SMALL])
def test_one_tf32_pass_misses_the_f32_tolerance(label, B, H, KV, S, D,
                                                dtype, window, cap):
    """hi·hi alone (one TF32 pass a product) misses BWD_TOL[f32] against
    the plain backward, which is why the kernel runs three."""
    args, mode = _case(label, B, H, KV, S, D, dtype, window, cap)
    got = emulate(*args, passes=1, **mode)
    want = flash_attention_bwd_ref(*args, **mode)
    worst = max(_rel(a, b) for a, b in zip(got, want))
    assert worst > BWD_TOL[torch.float32], worst


def test_tf32_split_is_exact_to_two_to_the_minus_22():
    """hi + lo recovers x to 2^-22 of its value, both halves TF32."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32)) * 40.0
    hi, lo = split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_bwd_workspace_at_qwen_shape_is_under_half_a_gigabyte(dtype):
    """The backward's workspace at Qwen2.5-3B's training shape (B = 1,
    H = 16, KV = 2, S = 4,096, D = 128): Δ and the G = 8 dK and dV
    partials in f32, and for f32 the TF32 halves; under 0.5 GB."""
    from repro_torch.kernels.flash_attention import bwd_workspace_floats

    B, H, KV, S, D = chip_smoke.BWD_SHAPES[0][1:6]
    G = H // KV
    n = bwd_workspace_floats(B, H, KV, S, S, D, dtype)
    base = B * H * S + 2 * G * B * KV * S * D
    if dtype == torch.bfloat16:
        assert n == base
    else:
        halves = 8 * B * H * S * D + 6 * B * KV * S * D
        assert n == base + halves
    assert 4 * n < 0.5e9


def test_bwd_workspace_pads_each_piece_to_64_floats():
    """A ragged shape (S = 130, D = 256, as chip_smoke's small entries):
    each piece rounded up to 64 floats, the transposes' rows to 8
    positions, in the order the kernel carves them."""
    from repro_torch.kernels.flash_attention import bwd_workspace_floats

    def r(n):
        return -(-n // 64) * 64

    B, H, KV, S, D = 2, 6, 2, 130, 256
    nq, nk = B * H * S * D, B * KV * S * D
    base = r(B * H * S) + r(2 * (H // KV) * nk)
    assert bwd_workspace_floats(B, H, KV, S, S, D, torch.bfloat16) == base
    assert bwd_workspace_floats(B, H, KV, S, S, D, torch.float32) == (
        base + 4 * r(nq) + 4 * r(B * H * D * 136) + 4 * r(nk)
        + 2 * r(B * KV * D * 136))
