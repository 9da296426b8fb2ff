"""XLA's CPU elementwise math, reproduced bit for bit in torch.

The JAX package computes its clustering features and its outage threshold
as ``10 * jnp.log10(jnp.maximum(snr, 1e-12))`` on XLA's CPU backend.  XLA
does not call libm's ``logf`` there: it inlines its own polynomial
``log_f32`` into the fused loop, and LLVM contracts some of its
multiply-adds into FMAs.  A correctly rounded log differs from it in about
2.4 % of f32 values, and at a cluster-head tie one ulp of a feature picks
the head.  So the port evaluates XLA's own sequence:

- the constants and the order of the operations are those of the fused
  loop's optimised LLVM IR (`--xla_dump_to`, the ``*.ir-with-opt.ll`` of
  the fusion);
- the FMAs are those of its machine code (``objdump -d`` of the dump's
  ``*.obj-file.*.o``: ``vfmadd``/``vfnmadd``), each evaluated exactly and
  rounded once (`_fma_f32`).

``jnp.log10`` is ``log(x) * f32(1/ln 10)``, itself a jitted function.
Eagerly, ``10 * log10(x)`` runs it, then a second dispatch multiplies by
10, rounding twice.  Under ``jit`` XLA folds the two constants into one,
``f32(f32(1/ln 10) * 10)``, and multiplies once.  Where the input is a
constant of the trace, XLA folds the whole expression at compile time,
with another log (`db10`).

Checked bitwise against ``jax.jit(jnp.log)`` on every f32 of [1, 2) and on
2²² log-uniform values in [1e-12, 1e12], and against both ``10 *
log10`` paths (`tests/test_torch_xla_math.py`), with jaxlib 0.9.0 on
x86-64 with AVX-512.
"""
from __future__ import annotations

import struct

import torch


def _f64(bits: int) -> float:
    """An f32 constant as LLVM IR prints it: the f64 of the same value."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# The constants of the fused loop's IR, each exactly an f32.
_FLT_MIN = _f64(0x3810000000000000)          # smallest normal f32
_SQRT_HALF = _f64(0x3FE6A09E60000000)        # √½ rounded to f32
_P = [_f64(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000,
                        0x3FBDE4A340000000,  # chain 1: c0, c1, c2
                        0xBFBFCBA9E0000000, 0x3FC23D37E0000000,
                        0xBFC555CA00000000,  # chain 2: c3, c4, c5
                        0x3FC999D580000000, 0xBFCFFFFF80000000,
                        0x3FD5555540000000)]  # chain 3: c6, c7, c8
_LN2_HI = _f64(0x3FE6300000000000)           # ln 2 = hi + lo
_LN2_LO = _f64(0xBF2BD01060000000)
# jnp.log10's factor, f32(1/ln 10), and XLA's folding of it with 10.
INV_LN10 = struct.unpack("<f", struct.pack("<f", 0.4342944819032518))[0]
TEN_INV_LN10 = _f64(0x40115F2D00000000)


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fma(a, b, c) of f32 operands, rounded once to f32: a·b is exact in
    f64, the f64 sum's error is recovered with a two-sum and folded in by
    rounding to odd, so the last rounding, to f32, is the only one."""
    a = a.double()
    p = a * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # The last bit of s's 53-bit significand, read without a dtype view
    # (``torch.func.vmap`` has no batching rule for one).
    odd = torch.fmod(torch.frexp(s).mantissa * 2.0 ** 53, 2.0) != 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` of an f32 tensor, bit for bit as XLA's CPU backend
    computes it (jaxlib 0.9.0).  Any device: the FMAs are taken in f64."""
    x = x.to(torch.float32)
    nonpos = ~(x > 0)                  # `fcmp ule x, 0`: NaN too
    zero = x == 0
    inf = x == torch.inf
    xc = torch.where(x <= _FLT_MIN, torch.full_like(x, _FLT_MIN), x)
    # The mantissa in [0.5, 1) and the exponent that goes with it: XLA
    # masks the bits, ``frexp`` gives the same two of a normal number
    # (and runs under ``torch.func.vmap``, where a dtype view does not).
    m, ex = torch.frexp(xc)
    e = ex.to(torch.float32)
    low = m < _SQRT_HALF               # shift [0.5, √½) to [1, √2)
    u = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    z = u * u
    u3 = z * u
    # The degree-9 polynomial in three interleaved chains, each step one
    # vfmadd.
    y1 = _fma_f32(_fma_f32(u, _P[0], _P[1]), u, _P[2])
    y2 = _fma_f32(_fma_f32(u, _P[3], _P[4]), u, _P[5])
    y3 = _fma_f32(_fma_f32(u, _P[6], _P[7]), u, _P[8])
    y = _fma_f32(_fma_f32(y1, u3, y2), u3, y3)
    # The last y·u³ is fused with e·ln2_lo; u − ½u² is one vfnmadd; e·ln2_hi
    # is fused into the last add.
    t = _fma_f32(y, u3, e * _LN2_LO)
    r = _fma_f32(z, -0.5, u) + t
    r = _fma_f32(e, _LN2_HI, r)
    r = torch.where(nonpos, torch.full_like(r, torch.nan), r)
    r = torch.where(zero, torch.full_like(r, -torch.inf), r)
    return torch.where(inf, torch.full_like(r, torch.inf), r)


DB_MODES = ("eager", "jit", "folded")


def db10(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``10 * jnp.log10(jnp.maximum(x, 1e-12))`` as XLA computes it on the
    CPU in one of three contexts:

    - ``"eager"``: the log10 function's fused loop (`xla_log_f32`, then
      the multiply by f32(1/ln 10)), then a second dispatch's multiply by
      10;
    - ``"jit"``: one fused loop, `xla_log_f32` and one multiply by the
      folded constant;
    - ``"folded"``: ``x`` a constant of the trace, so XLA's constant
      folding evaluates it at compile time: log in f64 rounded to f32,
      then the two multiplies as eagerly (bitwise on 20,000 log-uniform
      values, where glibc's ``logf`` misses 6)."""
    x = torch.clamp(x.to(torch.float32), min=1e-12)
    if mode == "folded":
        ln = torch.log(x.double()).to(torch.float32)
    elif mode in ("eager", "jit"):
        ln = xla_log_f32(x)
    else:
        raise ValueError(f"mode must be one of {DB_MODES}, got {mode!r}")
    if mode == "jit":
        return ln * TEN_INV_LN10
    return (ln * INV_LN10) * 10.0
