"""The phase-1 OTA MAC of CWFL: wrapper of the Hopper kernel.

Port of `repro.kernels.ota_aggregate`.  For every cluster c the head
receives the over-the-air superposition of its members' signals plus its
receiver noise (eq. 7/8 after channel inversion):

    y = W·S + N          W (C, K), S (K, d), N (C, d)  ->  y (C, d)

with f32 sums, y in S's dtype.

On a CUDA tensor :func:`ota_aggregate` launches the kernel in
``csrc/ota_aggregate.cu`` (built with ``nvcc`` at first use, see
`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the plain
version `repro_torch.kernels.ref.ota_aggregate_ref`.  There is no fallback
from one to the other.

The JAX entry's ``tile`` (the d-tile of its Pallas grid) and ``interpret``
(the Pallas interpreter off the TPU) are TPU choices and are dropped, as is
the JAX flat route's ``use_pallas``/``PALLAS_MIN_DIM`` cut: on the card the
kernel runs at every d.  One launch computes all C rows and reads S once
for them (where the K x tile block of S fits in shared memory beside W;
else once for each pass of rows), at any C and K with C·K < 2^31: the
kernel's ``ota::make_plan`` (``csrc/ota_plan.h``) picks the path and the
layout, and :func:`launch_plan` reads it back.

With a leading trajectory axis on every argument (signals (B, K, d),
weights (B, C, K), noise (B, C, d)) one launch computes the B products of
a Monte-Carlo sweep's stacked trajectories, each with its own weights and
noise: the counterpart of ``jax.vmap`` over the Pallas call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ref import ota_aggregate_ref

SOURCE = Path(__file__).with_name("csrc") / "ota_aggregate.cu"
#: The launch plan, included by SOURCE: plain C++ that the host's compiler
#: also builds alone (the CPU tests do).
PLAN_HEADER = SOURCE.with_name("ota_plan.h")

#: Kernel launches so far: raised by one per launch, and nowhere else.
launches = 0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch covers (C, K, d), as the kernel's ``ota::make_plan``
    decides it."""
    ring: bool          # the ring; else the column path
    warps: int          # a block's warps
    tile: int           # columns of a block's tile
    rows: int           # R, rows of W a warp takes (the column path: C)
    k_chunk: int        # rows of S a stage holds; 0: all K, S resident
    blocks_per_sm: int  # the ring's persistent blocks an SM (0: none)
    tiles: int          # ceil(d / tile)
    grid: int           # blocks (a trajectory's)
    smem_bytes: int
    passes: int         # passes over C's rows, each streaming S once
    batch: int = 1      # trajectories, the grid's y dimension


def read_plan(lib, K: int, C: int, d: int, dtype: torch.dtype,
              noise_dtype: torch.dtype, num_sms: int, batch: int = 1):
    """The plan for W (C, K) against S (K, d) of ``dtype`` and N of
    ``noise_dtype`` on a card of ``num_sms`` SMs, ``batch`` trajectories
    at once, from ``lib``'s ``ota_aggregate_plan_batched`` (the kernel's
    library, or the plan header built alone); None when the shape lies
    beyond one launch."""
    fn = lib.ota_aggregate_plan_batched
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    if fn(K, C, d, dtype.itemsize, noise_dtype.itemsize, num_sms, batch,
          out):
        return None
    return LaunchPlan(bool(out[0]), *out[1:], batch=batch)


def launch_plan(K: int, C: int, d: int, dtype: torch.dtype,
                noise_dtype: torch.dtype, device=None, batch: int = 1):
    """The kernel's plan on ``device`` (a CUDA device; builds the kernel)."""
    index = torch.device(device if device is not None else "cuda").index
    return read_plan(_library(), K, C, d, dtype, noise_dtype,
                     _num_sms(torch.cuda.current_device()
                              if index is None else index), batch)


def launch_error(err: int, K: int, C: int, d: int) -> Exception:
    """The exception for the kernel's status ``err``: -1 is a shape beyond
    one launch (``ota::make_plan``), anything else a CUDA error."""
    if err == -1:
        return ValueError(
            f"ota_aggregate takes C·K < 2^31 weights and a grid of fewer "
            f"than 2^31 tiles and items a block in one launch, got K={K}, "
            f"C={C}, d={d}")
    return RuntimeError(f"ota_aggregate kernel launch failed: CUDA error "
                        f"{err} (K={K}, C={C}, d={d})")


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for fn in (lib.ota_aggregate_f32, lib.ota_aggregate_bf16,
               lib.ota_aggregate_bf16_bf16noise):
        # s, w, w_bf16, n, out, K, C, d, batch, stream
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(signals, weights, noise):
    if signals.ndim not in (2, 3):
        raise ValueError(f"signals must be (K, d) or (B, K, d), got "
                         f"{tuple(signals.shape)}")
    lead = tuple(signals.shape[:-2])
    K, d = signals.shape[-2:]
    C = weights.shape[-2] if weights.ndim == signals.ndim else -1
    for name, x, shape in (("weights", weights, lead + (C, K)),
                           ("noise", noise, lead + (C, d))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} for signals "
                             f"{tuple(signals.shape)} and weights "
                             f"{lead + ('C', K)}, got {tuple(x.shape)}")
        if x.device != signals.device:
            raise ValueError(f"{name} is on {x.device}, signals on "
                             f"{signals.device}")
    if min(K, C, d) < 1:
        raise ValueError(f"K, C and d must be at least 1, got {(K, C, d)}")
    if signals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"signals must be float32 or bfloat16, got "
                        f"{signals.dtype}")
    if not weights.is_floating_point():
        raise TypeError(f"weights must be floating point, got "
                        f"{weights.dtype}")
    if noise.dtype not in (torch.float32, signals.dtype):
        raise TypeError(f"noise must be float32 or the signals' "
                        f"{signals.dtype}, got {noise.dtype}")


def ota_aggregate(signals: torch.Tensor, weights: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """y = weights @ signals + noise, fused, with f32 sums.

    signals: (K, d) f32 or bf16; weights: (C, K), any float type (used as
    f32; f32 and bf16 go to the kernel as they are); noise: (C, d), f32 or
    the signals' dtype.  Returns (C, d) in the
    signals' dtype; with a leading trajectory axis B on every argument,
    (B, C, d) from one launch.
    """
    global launches
    _check(signals, weights, noise)
    if signals.device.type == "cpu":
        return ota_aggregate_ref(signals, weights, noise)
    if signals.device.type != "cuda":
        raise ValueError(f"ota_aggregate runs on CUDA or the CPU, not "
                         f"{signals.device}")
    for name, x in (("signals", signals), ("noise", noise)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    batch = signals.shape[0] if signals.ndim == 3 else 1
    K, d = signals.shape[-2:]
    C = weights.shape[-2]
    if not 1 <= batch <= 65535:
        raise ValueError(f"the kernel takes 1..65535 trajectories, got "
                         f"{batch}")
    # The kernel widens bf16 weights to f32 as it stages them, as the JAX
    # kernel casts its weight block; other dtypes (O(C·K)) are cast here.
    w_bf16 = weights.dtype == torch.bfloat16
    w = (weights if w_bf16 else weights.to(torch.float32)).contiguous()
    out = torch.empty(signals.shape[:-2] + (C, d), dtype=signals.dtype,
                      device=signals.device)
    lib = _library()
    fn = (lib.ota_aggregate_f32 if signals.dtype == torch.float32 else
          lib.ota_aggregate_bf16 if noise.dtype == torch.float32 else
          lib.ota_aggregate_bf16_bf16noise)
    with torch.cuda.device(signals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(signals.data_ptr(), w.data_ptr(), int(w_bf16),
                 noise.data_ptr(), out.data_ptr(), K, C, d, batch, stream)
    if err != 0:
        raise launch_error(err, K, C, d)
    launches += 1
    return out
