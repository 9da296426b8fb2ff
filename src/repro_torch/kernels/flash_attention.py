"""Blockwise flash attention: wrapper of the Hopper kernels.

Port of `repro.kernels.flash_attention`.  Online-softmax attention with
grouped KV heads (query head h reads KV head h // G), a causal mask, a
sliding window, a tanh logit softcap and the pad mask ``k < Skv``:

    s = cap · tanh(((q · scale) kᵀ) / cap)     f32 sums; the cap if > 0
    s = −1e30 where masked
    o = softmax(s) v                           in q's dtype

``scale`` defaults to D^-0.5, the Pallas kernel's; the model's op passes
1.0 and scales q itself, in q's dtype, as the JAX model does.  Two
designs, one for each dtype, both on the tensor cores and built with
``nvcc`` at first use (see `repro_torch.kernels._build`):

- f32: ``csrc/flash_attention.cu``: a split pass writes the TF32 hi and
  lo halves of q·scale, k and vᵀ into a workspace, then a warp-specialised
  kernel (one producer warp issuing TMA loads into a 4-slot ring, one
  consumer warpgroup running ``wgmma``) computes both products as three
  TF32 passes (hi·hi + hi·lo + lo·hi), which keeps f32 accuracy;
- bf16: ``csrc/flash_attention_sm90.cu``: a warp-specialised kernel (one
  producer warpgroup issuing TMA loads into a 2-stage ring, two consumer
  warpgroups running ``wgmma``), P split into two bf16 terms
  (P_hi + P_lo) for P·V, so that P keeps f32's accuracy as in JAX.

On a CUDA tensor :func:`flash_attention` launches the kernel of q's dtype
or raises; on a CPU tensor it runs the plain version
`repro_torch.kernels.ref.flash_attention_ref`.  There is no fallback from
one to another.

Training: when q, k or v requires grad, :func:`flash_attention` runs
through :class:`FlashAttentionFn`, whose forward asks the kernel for the
row statistics lse = m + log l as well (the serve path passes a null
pointer and writes none) and whose backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`: a Δ
pre-pass, a dK/dV kernel whose blocks each take one query head of a KV
head, a dQ kernel and a fixed-order sum of the dK/dV partials, products
on ``wgmma``: bf16 as it is, f32 as three TF32 passes over halves that
a split pass writes; no atomics, so the gradients are bitwise the same
run to run).  On the
CPU both directions run the plain versions (`flash_attention_ref` with
``return_lse``, `flash_attention_bwd_ref`); autograd never runs through
the plain forward on a CUDA tensor.

A row with no valid key at all has no meaningful value in any kernel:
the Pallas kernel gives mean(v) (its −1e30 scores tie), these mean(v)
over the KV tiles they visit, or 0 where they skip them all; the plain
version gives 0.  Causal attention over a prompt never has such a row,
and the tests avoid it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

_CSRC = Path(__file__).with_name("csrc")
#: The f32 kernel (3×TF32 wgmma + TMA) and the bf16 kernel (wgmma + TMA).
SOURCE_F32 = _CSRC / "flash_attention.cu"
SOURCE_BF16 = _CSRC / "flash_attention_sm90.cu"
#: The forward kernels, one for each dtype.
SOURCES = (SOURCE_F32, SOURCE_BF16)
#: The backward kernels, both dtypes (bf16 and 3×TF32 ``wgmma`` + TMA).
SOURCE_BWD = _CSRC / "flash_attention_bwd.cu"
#: The head dimensions both kernels are instantiated for.
HEAD_DIMS = (32, 64, 128, 256)

#: Kernel launches so far: the forward in f32 and bf16, the backward in
#: f32 and bf16; each raised by one per launch of its kernel (one call of
#: its C entry), and nowhere else.
launches = 0
launches_bf16 = 0
launches_bwd = 0
launches_bwd_bf16 = 0


@functools.cache
def _library(dtype: torch.dtype):
    """The entry point of ``dtype``'s forward kernel, its library built and
    loaded at the first call (never at import)."""
    # The f32 entry takes a workspace pointer after the output; both take
    # the lse pointer (null when serving) last.
    if dtype == torch.float32:
        fn = load_library(SOURCE_F32).flash_attention_f32
        pointers = 6
    else:
        fn = load_library(SOURCE_BF16).flash_attention_bf16
        pointers = 5
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library_bwd(dtype: torch.dtype):
    """The backward kernel's entry point for ``dtype``: q, k, v, o, lse,
    do, dq, dk, dv and the workspace (:func:`bwd_workspace_floats`), then
    the shapes and the mode."""
    lib = load_library(SOURCE_BWD)
    fn = (lib.flash_attention_bwd_f32 if dtype == torch.float32
          else lib.flash_attention_bwd_bf16)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def workspace_floats(B: int, H: int, KV: int, Sq: int, Skv: int,
                     D: int) -> int:
    """Floats of the f32 kernel's workspace: the TF32 hi and lo halves of
    q (B, H, Sq, D), of k (B, KV, Skv, D) and of vᵀ (B, KV, D, Skv rounded
    up to 8), in this order (the layout ``csrc/flash_attention.cu``
    carves)."""
    return 2 * (B * H * Sq * D + B * KV * Skv * D
                + B * KV * D * (-(-Skv // 8) * 8))


def bwd_workspace_floats(B: int, H: int, KV: int, Sq: int, Skv: int,
                         D: int, dtype: torch.dtype) -> int:
    """Floats of the backward's workspace, in the order
    ``csrc/flash_attention_bwd.cu`` carves it, each piece rounded up to 64
    floats: Δ (B, H, Sq); the dK and the dV partials, (G, B, KV, Skv, D)
    each; for f32 then the TF32 hi and lo halves of q·scale and dO
    (B, H, Sq, D), of their transposes (B, H, D, Sq rounded up to 8), of
    k and v (B, KV, Skv, D) and of kᵀ (B, KV, D, Skv rounded up to 8)."""
    def r(n: int) -> int:
        return -(-n // 64) * 64

    nkv = B * KV * Skv * D
    n = r(B * H * Sq) + r(2 * (H // KV) * nkv)
    if dtype == torch.float32:
        sq8, skv8 = -(-Sq // 8) * 8, -(-Skv // 8) * 8
        n += (4 * r(B * H * Sq * D) + 4 * r(B * H * D * sq8) + 4 * r(nkv)
              + 2 * r(B * KV * D * skv8))
    return n


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, heads, S, D)")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B={B}, KV, Skv, D={D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")


def _check_cuda(*tensors) -> None:
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _forward(q, k, v, causal: bool, window: int, cap: float, scale: float,
             with_lse: bool):
    """``(o, lse)``: the kernel of q's dtype on a CUDA tensor, the plain
    version on a CPU one; ``lse`` (B, H, Sq) f32 only ``with_lse``, else
    None."""
    global launches, launches_bf16
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap, scale=scale, return_lse=True)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, scale=scale), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    _check_cuda(("q", q), ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    fn = _library(q.dtype)
    pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if q.dtype == torch.float32:
        work = torch.empty(workspace_floats(B, H, KV, Sq, Skv, D),
                           dtype=torch.float32, device=q.device)
        pointers.append(work.data_ptr())
    pointers.append(None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(*pointers, B, H, KV, Sq, Skv, D, int(causal), int(window),
                 float(cap), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (1000 + n: CUresult n encoding a "
                           f"tensor map; q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    if q.dtype == torch.float32:
        launches += 1
    else:
        launches_bf16 += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, cap: float = 0.0,
                        scale: float | None = None):
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in the
    dtypes of q, k and v, from the forward's output ``o`` and row
    statistics ``lse`` (B, H, Sq) f32 and the output's gradient ``do``.
    On a CUDA tensor it launches ``csrc/flash_attention_bwd.cu`` or
    raises; on a CPU tensor it runs `flash_attention_bwd_ref`."""
    global launches_bwd, launches_bwd_bf16
    _check(q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and do must be {q.dtype}, got {o.dtype} and "
                        f"{do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    _check_cuda(("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                ("do", do))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    work = torch.empty(bwd_workspace_floats(B, H, KV, Sq, Skv, D, q.dtype),
                       dtype=torch.float32, device=q.device)
    fn = _library_bwd(q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), work.data_ptr(), B, H, KV, Sq, Skv, D,
                 int(causal), int(window), float(cap), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err} (1000 + n: CUresult n encoding "
                           f"a tensor map; q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    if q.dtype == torch.float32:
        launches_bwd += 1
    else:
        launches_bwd_bf16 += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward saves q, k, v,
    o and the row statistics, the backward is :func:`flash_attention_bwd`
    (the kernel on CUDA, the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        o, lse = _forward(q, k, v, causal, window, cap, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode = {"causal": causal, "window": window, "cap": cap,
                    "scale": scale}
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.mode)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, cap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Skv, D) with H a multiple of KV.
    ``window`` > 0 keeps keys k > q − window; ``cap`` > 0 soft-caps the
    scores; ``scale`` multiplies q (default D^-0.5).  Returns (B, H, Sq,
    D) in q's dtype, differentiable (:class:`FlashAttentionFn`) when an
    input requires grad."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, cap, scale)
    return _forward(q, k, v, causal, window, cap, scale, False)[0]
