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
kernel runs at every d.  The kernel reads S once for up to
``MAX_CLUSTERS`` clusters; more clusters run in groups of that many, one
launch (and one read of S) a group.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ref import ota_aggregate_ref

SOURCE = Path(__file__).with_name("csrc") / "ota_aggregate.cu"
# The kernel keeps the C sums of its columns in registers, templated on C.
MAX_CLUSTERS = 16
# W (C·K floats of a group) is staged in shared memory; a block may opt in
# to this much of it on Hopper.
MAX_SHARED_BYTES = 232448

#: Kernel launches so far: raised by one per launch, and nowhere else.
launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for fn in (lib.ota_aggregate_f32, lib.ota_aggregate_bf16,
               lib.ota_aggregate_bf16_bf16noise):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(signals, weights, noise):
    if signals.ndim != 2:
        raise ValueError(f"signals must be (K, d), got {tuple(signals.shape)}")
    K, d = signals.shape
    C = weights.shape[0] if weights.ndim == 2 else -1
    for name, x, shape in (("weights", weights, (C, K)),
                           ("noise", noise, (C, d))):
        if x.ndim != 2 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} for signals {(K, d)} "
                             f"and weights (C, K), got {tuple(x.shape)}")
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
    f32); noise: (C, d), f32 or the signals' dtype.  Returns (C, d) in the
    signals' dtype.
    """
    global launches
    _check(signals, weights, noise)
    if signals.device.type == "cpu":
        return ota_aggregate_ref(signals, weights, noise)
    if signals.device.type != "cuda":
        raise ValueError(f"ota_aggregate runs on CUDA or the CPU, not "
                         f"{signals.device}")
    K, d = signals.shape
    C = weights.shape[0]
    group = min(C, MAX_CLUSTERS)
    if 4 * group * K > MAX_SHARED_BYTES:
        raise ValueError(f"K={K} clients, {group} clusters a launch: the "
                         f"weights exceed {MAX_SHARED_BYTES} bytes of shared "
                         f"memory (K <= {MAX_SHARED_BYTES // (4 * group)})")
    for name, x in (("signals", signals), ("noise", noise)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The weights are O(C·K): cast and pack them here, as the JAX kernel
    # casts its weight block.
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((C, d), dtype=signals.dtype, device=signals.device)
    lib = _library()
    fn = (lib.ota_aggregate_f32 if signals.dtype == torch.float32 else
          lib.ota_aggregate_bf16 if noise.dtype == torch.float32 else
          lib.ota_aggregate_bf16_bf16noise)
    with torch.cuda.device(signals.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, C, MAX_CLUSTERS):
            g = min(MAX_CLUSTERS, C - c0)
            err = fn(signals.data_ptr(), w[c0].data_ptr(),
                     noise[c0].data_ptr(), out[c0].data_ptr(), K, g, d,
                     stream)
            if err != 0:
                raise RuntimeError(f"ota_aggregate kernel launch failed: "
                                   f"CUDA error {err} (K={K}, clusters "
                                   f"{c0}..{c0 + g - 1}, d={d})")
            launches += 1
    return out
