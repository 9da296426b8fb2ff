"""The arithmetic of the f32 ``flash_attention`` kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``), emulated on the CPU:
every operand split into two TF32 values (hi = the f32 rounded to TF32,
ties away from zero, by bit masks; lo = TF32 of the rest), both products
as three TF32 passes (hi·hi + hi·lo + lo·hi), S's hi·hi pass and its two
correction passes summed apart, P·V in pieces of 64 output columns added
to O in f32, and the online softmax over tiles of 64 keys in f32, each
64-row query block visiting the KV tiles the kernel visits.  Held
against the port's plain version and the JAX Pallas kernel (interpret
mode) at ``chip_smoke.py``'s small f32 shapes, q scaled by 4 as there,
within its ``FA_TOL``; a single TF32 pass misses that tolerance.  This
checks the accuracy argument of the kernel's design, not the kernel."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_fa
from repro_torch.kernels.ref import flash_attention_ref

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = chip_smoke.FA_TOL["small_f32"]
SMALL = [s for s in chip_smoke.FA_SHAPES
         if s[0].startswith("small") and s[6] == torch.float32]
BQ = BK = 64    # the kernel's query block and KV tile
NP = 64         # the kernel's pieces of P·V (output columns)
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 kept in f32: round to nearest, ties away from zero
    (add half of the dropped range to the bits, clear the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, passes: int):
    """a @ b.T with TF32 operands: three passes (the hi·hi term and the
    two correction terms summed apart, as the kernel does for S) or one
    (hi·hi only)."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = ah @ bh.T
    if passes == 3:
        out = out + (ah @ bl.T + al @ bh.T)
    return out


def emulate(q, k, v, *, causal, window, cap, scale, passes=3):
    """The kernel's function computed with its arithmetic; q (B, H, Sq, D),
    k, v (B, KV, Skv, D), f32."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qs = q * scale
    out = torch.zeros_like(q)
    for b in range(B):
        for h in range(H):
            kk, vv = k[b, h // (H // KV)], v[b, h // (H // KV)]
            vh, vl = split(vv)
            for q0 in range(0, Sq, BQ):
                rows = qs[b, h, q0:q0 + BQ]
                qpos = torch.arange(q0, q0 + rows.shape[0])[:, None]
                k_end = min(Skv, q0 + BQ, Sq) if causal else Skv
                k_begin = max(0, q0 - window + 1) // BK * BK if window else 0
                m = torch.full((rows.shape[0], 1), NEG_INF)
                l = torch.zeros((rows.shape[0], 1))
                acc = torch.zeros((rows.shape[0], D))
                for k0 in range(k_begin, k_end, BK):
                    kpos = torch.arange(k0, min(k0 + BK, Skv))[None, :]
                    s = product(rows, kk[k0:k0 + BK], passes)
                    if cap > 0:
                        s = cap * torch.tanh(s / cap)
                    ok = torch.ones_like(s, dtype=torch.bool)
                    if causal:
                        ok &= kpos <= qpos
                    if window:
                        ok &= kpos > qpos - window
                    s = torch.where(ok, s, NEG_INF)
                    m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = l * corr + p.sum(dim=1, keepdim=True)
                    acc = acc * corr
                    ph, pl = split(p)
                    for c0 in range(0, D, NP):
                        cols = slice(c0, c0 + NP)
                        piece = ph @ vh[k0:k0 + BK, cols]
                        if passes == 3:
                            piece = (piece + pl @ vh[k0:k0 + BK, cols]
                                     + ph @ vl[k0:k0 + BK, cols])
                        acc[:, cols] += piece
                    m = m_new
                out[b, h, q0:q0 + BQ] = acc / torch.clamp(l, min=1e-30)
    return out


def _inputs(B, H, KV, S, D, seed):
    """chip_smoke's inputs in distribution (q scaled by 4 so that the
    scores reach past ±15 and the softcap bends them), drawn with numpy."""
    rng = np.random.default_rng(seed)
    return ((4 * rng.standard_normal((B, H, S, D))).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    """The bit-mask rounding keeps 10 mantissa bits: exact on TF32
    values, to nearest otherwise, ties away from zero, signs kept."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp, 1 + ulp / 2, 1 + ulp / 4,
                      1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0e-3],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp)]
    got = tf32(x)
    assert got[:6].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(x)
    assert float((hi + lo - x).abs().max()) <= 2.0 ** -22 * 3


@pytest.mark.parametrize("label,B,H,KV,S,D,dtype,window,cap", SMALL,
                         ids=[s[0] for s in SMALL])
def test_three_tf32_passes_meet_the_f32_tolerance(label, B, H, KV, S, D,
                                                  dtype, window, cap):
    """The emulated kernel against the port's plain version and JAX's
    Pallas kernel (interpret mode) within FA_TOL['small_f32']."""
    args = _inputs(B, H, KV, S, D, seed=S + D + window)
    mode = {"causal": True, "window": window, "cap": cap}
    q, k, v = (torch.from_numpy(a) for a in args)
    got = emulate(q, k, v, scale=D ** -0.5, **mode).numpy()
    want_ref = flash_attention_ref(q, k, v, **mode).numpy()
    want_jax = np.asarray(jax_fa(*(jnp.asarray(a) for a in args),
                                 block_q=64, block_k=64, **mode))
    for want in (want_ref, want_jax):
        assert float(np.abs(got - want).max()) <= TOL


def _truth(q, k, v, *, causal, window, cap):
    """The same function in float64 (the plain version's formula)."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    qg = (q.double() * D ** -0.5).reshape(B, KV, H // KV, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.double())
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    ok = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
    if window:
        ok &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~ok, -torch.inf), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", p, v.double()).reshape(q.shape)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """At the D = 256 shape, against the function in float64: three
    passes are as accurate as the plain version's own f32 arithmetic
    (within twice its error; both are some 1e-5 off at scores of ±20),
    one pass (hi·hi only, for both products) is hundreds of times
    further off and misses FA_TOL['small_f32'] tenfold, which is why the
    kernel takes three."""
    label, B, H, KV, S, D, _, window, cap = next(
        s for s in SMALL if s[5] == 256)
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(B, H, KV, S, D, seed=S + D + window))
    mode = {"causal": True, "window": window, "cap": cap}
    truth = _truth(q, k, v, **mode)

    def err(x):
        return float((x.double() - truth).abs().max())

    plain = err(flash_attention_ref(q, k, v, **mode))
    three = err(emulate(q, k, v, scale=D ** -0.5, **mode))
    one = err(emulate(q, k, v, scale=D ** -0.5, passes=1, **mode))
    assert 0.0 < plain < TOL
    assert three <= 2 * plain
    assert one > 10 * TOL and one > 100 * three
