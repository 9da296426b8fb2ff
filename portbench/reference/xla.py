"""A frozen copy of the simulator's plain elementwise channel arithmetic.

The federated simulator computes its clustering features, its link SNRs
and the channel process in the sequence of XLA's CPU loops (glibc's
``powf``, XLA's polynomial ``log``, XLA's complex ``abs``, the FMAs and
folded constants of the jitted round), so that a cluster-head election
that turns on the last ulp of an SNR elects the same heads everywhere.
A head election is a discrete decision: a reference that took the logs
in another rounding would elect other heads at a tie and then follow
another trajectory altogether.  So the reference takes the same plain
arithmetic, copied here once and frozen, with no import of the program.
What it checks is everything the program computes from these numbers on
the card: the channel kernel's step and view, the K-means and election,
the power and weights, the fused round kernel, local training and the
evaluation.

The functions run on any device: each FMA is taken in f64 and rounded
once, each ``sqrt`` in f64.
"""
from __future__ import annotations

import math
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


# glibc 2.36's powf (sysdeps/ieee754/flt-32/e_powf.c, compiled with FMA):
# log2(x) from a 16-entry table of (1/c, log2 c) and a degree-5
# polynomial, 2^(y·log2 x) from a 32-entry table of 2^(i/32) and a
# cubic, all in f64.
_POWF_LOG2_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")            # 0x1.8p52 / 32
_EXP2F_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
# |y·log2 x| beyond these overflows / underflows (e_powf.c's bounds).
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """a·b = p + e exactly (Dekker's product, Veltkamp's split)."""
    p = a * b
    ta, tb = 134217729.0 * a, 134217729.0 * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """fma(a, b, c) of f64 tensors, rounded once (Boldo and Melquiond's
    emulation: the exact product and sum, their tail rounded to odd)."""
    b = b if torch.is_tensor(b) else torch.full_like(a, b)
    c = c if torch.is_tensor(c) else torch.full_like(a, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    odd = (v.view(torch.int64) & 1) != 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((err != 0) & ~odd, torch.nextafter(v, toward), v)
    return th + v


def glibc_powf(x: torch.Tensor, y) -> torch.Tensor:
    """``powf(x, y)`` of f32 tensors (broadcast), bit for bit glibc 2.36's
    FMA variant, which XLA's CPU ``pow`` calls.  Any device: f64
    arithmetic, its FMAs emulated by `fma_f64`.  Positive x (subnormals
    normalised as glibc does), and glibc's special cases for x or y in
    {0, ±inf, NaN}, x = 1, y = 0 and a negative x with an integral y."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    x, y = x.contiguous(), y.contiguous()
    dev = x.device
    ax = torch.abs(x)
    # An integral y: its parity signs the result of a negative x.
    y_int = torch.floor(y) == y
    odd = y_int & (torch.fmod(torch.abs(y), 2.0) == 1.0)
    sign_bias = torch.where((x < 0) & odd, 1 << 16, 0)
    sub = ax < 2.0 ** -126
    axn = torch.where(sub, ax * 2.0 ** 23, ax)
    ix = axn.view(torch.int32).to(torch.int64) - torch.where(sub, 23 << 23, 0)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = (top - ((top & 0x80000000) << 1)) >> 23    # the sign-extended top
    iz = (ix - top) & 0xFFFFFFFF
    z = torch.where(iz >= 1 << 31, iz - (1 << 32), iz).to(
        torch.int32).view(torch.float32).double()
    tab = torch.tensor(_POWF_LOG2_TAB, dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    A = _POWF_LOG2_POLY
    r = fma_f64(z, invc, -1.0)
    y0 = logc + k.double()
    r2 = r * r
    p = fma_f64(r, A[0], A[1])
    q = fma_f64(r, A[2], A[3])
    r4 = r2 * r2
    q = fma_f64(r2, q, fma_f64(r, A[4], y0))
    ylogx = y.double() * fma_f64(r4, p, q)
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    rr = ylogx - kd
    e2 = torch.tensor([t - (1 << 64) if t >= 1 << 63 else t
                       for t in _EXP2F_TAB], dtype=torch.int64, device=dev)
    t = e2[ki & 31] + (((ki + sign_bias) & 0x1FFFF) << 47)
    C = _EXP2F_POLY
    s = fma_f64(fma_f64(rr, C[0], C[1]), rr * rr, fma_f64(rr, C[2], 1.0))
    out = (s * t.view(torch.float64)).to(torch.float32)
    # glibc's slow paths.
    inf = torch.full_like(out, torch.inf)
    sgn = torch.where(sign_bias != 0, -1.0, 1.0).to(torch.float32)
    out = torch.where(ylogx > _POWF_OFLOW, sgn * inf, out)
    out = torch.where(ylogx <= -150.0, sgn * 0.0, out)
    out = torch.where((ylogx > -150.0) & (ylogx < -149.0),
                      sgn * 2.0 ** -149, out)
    out = torch.where((x < 0) & ~y_int, torch.nan, out)
    out = torch.where(x == 0, torch.where(y < 0, sgn * inf, sgn * 0.0),
                      out)
    out = torch.where(torch.isinf(x),
                      torch.where(y < 0, sgn * 0.0, sgn * inf), out)
    out = torch.where(torch.isnan(x) | torch.isnan(y), torch.nan, out)
    out = torch.where(torch.isinf(y) & (ax == 1.0), 1.0, out)
    out = torch.where(torch.isinf(y) & (ax != 1.0) & ~torch.isnan(x),
                      torch.where((ax < 1.0) == (y < 0), inf, 0.0), out)
    out = torch.where(y == 0, 1.0, out)
    return torch.where(x == 1.0, 1.0, out)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded ``sqrt`` of an f32 tensor (XLA's ``vsqrtps``):
    taken in f64 and rounded, because ATen's vectorised f32 ``sqrt`` on the
    CPU misses the last bit of some values."""
    return torch.sqrt(x.double()).to(torch.float32)


def xla_abs(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``|re + i·im|`` of f32 parts as XLA's CPU backend computes a complex
    ``abs``: max·sqrt(fma(q, q, 1)), q = min/max over |re| and |im|, and
    min where that is NaN (0/0, inf/inf, a NaN part).  XLA's loops run
    with denormals flushed, so a subnormal part counts as 0."""
    ar, ai = torch.abs(re), torch.abs(im)
    ar = torch.where(ar < _FLT_MIN, 0.0, ar)
    ai = torch.where(ai < _FLT_MIN, 0.0, ai)
    mx, mn = torch.maximum(ar, ai), torch.minimum(ar, ai)
    q = mn / mx
    r = mx * sqrt_f32(_fma_f32(q, q, 1.0))
    return torch.where(torch.isnan(r), mn, r)


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32 (as a Python float)."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


def xla_pathloss(positions: torch.Tensor, d0: float, exponent: float,
                 mode: str) -> torch.Tensor:
    """`repro.core.topology.pathloss_amplitude` in context ``mode``:
    (…, K, K) (max(sqrt(Σ diff² + 1e-9), d0) / d0) ** exponent, Σ diff²
    eagerly the rounded squares added, under ``jit`` fma(d₁, d₁, d₀²)."""
    if mode not in ("eager", "jit"):
        raise ValueError(f"mode must be 'eager' or 'jit', got {mode!r}")
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    d0_, d1_ = diff[..., 0], diff[..., 1]
    ss = d0_ * d0_ + d1_ * d1_ if mode == "eager" else _fma_f32(
        d1_, d1_, d0_ * d0_)
    dist = torch.clamp(sqrt_f32(ss + 1e-9), min=d0)
    dist = dist / d0 if mode == "eager" else dist * f32(1.0 / d0)
    return glibc_powf(dist, f32(exponent))


def xla_link_snr(g_re: torch.Tensor, g_im: torch.Tensor, p_ref: float,
                 noise_var: float) -> torch.Tensor:
    """`repro.core.topology.link_stats`' ``|g|² · P_ref / σ²`` off the
    diagonal, as an eager dispatch computes it: three roundings (a round's
    view multiplies once, by the folded constant: `xla_channel_view`)."""
    K = g_re.shape[-1]
    off = 1.0 - torch.eye(K, device=g_re.device)
    a = xla_abs(g_re, g_im)
    return (((a * a) * f32(p_ref)) / f32(noise_var)) * off


def channel_constants(*, speed: float, fading_rho: float,
                      shadowing_rho: float, shadowing_std_db: float,
                      area_size: float, d0: float, pathloss_exp: float,
                      p_ref: float, noise_var: float,
                      outage_snr_db: float) -> dict:
    """The f32 constants of a jitted channel round, folded as XLA folds
    them: the AR(1) innovation scales sqrt(max(1 − ρ², 0)) taken in f32,
    the draws' factors f32(√2)·f32(1/√2) (fading) and f32(√2)·f32(σ)
    (shadowing), 1/20 and P_ref/σ²."""
    def ar1(rho):
        r = torch.tensor(rho, dtype=torch.float32)
        return float(sqrt_f32(torch.clamp(1.0 - r * r, min=0.0)))
    sqrt2 = f32(math.sqrt(2.0))
    return {
        "speed": f32(speed), "area": f32(area_size),
        "rho": f32(fading_rho), "innov_std": ar1(fading_rho),
        "rho_s": f32(shadowing_rho), "shadow_std": ar1(shadowing_rho),
        "fade_fold": f32(sqrt2 * f32(1.0 / sqrt2)),
        "shadow_fold": f32(sqrt2 * f32(shadowing_std_db)),
        "inv_d0": f32(1.0 / d0), "d0": f32(d0),
        "exponent": f32(-pathloss_exp / 2.0), "inv20": f32(1.0 / 20.0),
        "snr_scale": f32(f32(p_ref) * f32(1.0 / noise_var)),
        "outage_db": f32(outage_snr_db)}


def _mirror(m: torch.Tensor, neg: bool) -> torch.Tensor:
    """The strict upper triangle mirrored below (negated for the
    imaginary part of a conjugate), the diagonal its own mirror."""
    K = m.shape[-1]
    iu = torch.triu(torch.ones(K, K, dtype=torch.bool, device=m.device),
                    diagonal=1)
    mt = m.transpose(-1, -2)
    return torch.where(iu, m, -mt if neg else mt)


def xla_channel_step(positions, waypoints, h_re, h_im, shadow, fade_re,
                     fade_im, shadow_n, way_u, c: dict):
    """`repro.sim.processes.step_channel` as the jitted round computes it
    (scan, loop and sweep alike), over any leading axes.  ``fade_*`` and
    ``shadow_n`` are erf_inv(u), the normals before their √2 (folded into
    ``c``); ``way_u`` the waypoint uniforms.  Returns (positions,
    waypoints, h_re, h_im, shadow)."""
    t = waypoints - positions
    dist = sqrt_f32(_fma_f32(t[..., 1], t[..., 1], t[..., 0] * t[..., 0])
                    + 1e-12)
    arrived = dist <= c["speed"]
    m = torch.clamp(c["speed"] / dist, max=1.0)[..., None]
    new_pos = _fma_f32(m.expand_as(t), t, positions)
    new_way = torch.where(arrived[..., None], way_u * c["area"], waypoints)
    wr = _mirror(fade_re * c["fade_fold"], neg=False)
    wi = _mirror(fade_im * c["fade_fold"], neg=True)
    new_re = c["rho"] * h_re + c["innov_std"] * wr
    new_im = c["rho"] * h_im + c["innov_std"] * wi
    n = _mirror(shadow_n * c["shadow_fold"], neg=False)
    new_sh = _fma_f32(torch.full_like(shadow, c["rho_s"]), shadow,
                      c["shadow_std"] * n)
    return new_pos, new_way, new_re, new_im, new_sh


def xla_channel_view(positions, h_re, h_im, shadow, c: dict):
    """`repro.sim.processes.channel_view` as the jitted round computes it,
    over any leading axes.  Returns (g_re, g_im, link_snr, adjacency)."""
    K = h_re.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=h_re.device)
    off = (~eye).to(torch.float32)
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    dist = sqrt_f32(_fma_f32(diff[..., 1], diff[..., 1],
                             diff[..., 0] * diff[..., 0]) + 1e-9)
    dist = torch.clamp(dist, min=c["d0"]) * c["inv_d0"]
    amp = (glibc_powf(dist, c["exponent"])
           * glibc_powf(torch.tensor(10.0, device=dist.device),
                        shadow * c["inv20"]))
    # The complex products by amp and by the mask, their zero terms kept
    # (they decide the signs of zeros).
    g_re = h_re * amp - h_im * 0.0
    g_im = h_im * amp + h_re * 0.0
    g_re, g_im = off * g_re - g_im * 0.0, off * g_im + g_re * 0.0
    a = xla_abs(g_re, g_im)
    snr = ((a * a) * c["snr_scale"]) * off
    adj = (db10(snr, "jit") >= c["outage_db"]) & ~eye
    return g_re, g_im, snr, adj
