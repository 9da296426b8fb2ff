"""The fused single-pass CWFL sync round: wrapper of the Hopper kernel.

Port of `repro.kernels.cwfl_round`.  One round of Algorithm 1 over the
flat ``(K, d)`` client signals:

    θ̃ = Ã·S + n₁          phase 1: intra-cluster OTA MAC      (C, d)
    θ̄ = B̃·θ̃ + n₂          phase 2: inter-head consensus mix   (C, d)
    new = M·θ̄             phase 3: error-free broadcast        (K, d)
    consensus = mean_c θ̄                                        (d,)

With a leading trajectory axis on every argument (signals (B, K, d),
phase1 (B, C, K), and so on) one launch runs the B rounds of a
Monte-Carlo sweep's stacked trajectories, each with its own weights and
noise: the counterpart of ``jax.vmap`` over the Pallas call.

``guard=True`` (fault scenarios) is the guarded variant, the port of
``_cwfl_round_kernel_guard``: non-finite signals count as 0, and an Ã row
with Σ|Ã| = 0 (a dead cluster) forces its θ̃ row, noise included, to 0.

On a CUDA tensor :func:`cwfl_round` launches the kernel in
``csrc/cwfl_round.cu`` (built with ``nvcc`` at first use, see
`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the plain
version `repro_torch.kernels.ref.cwfl_round_ref`.  There is no fallback
from one to the other.

The JAX package routes rounds below ``PALLAS_MIN_DIM`` = 512 to its jnp
reference (``cwfl_round_auto``).  That cut is a TPU tiling choice; on the
card the kernel runs at every d, so the port has no such route and the
core calls :func:`cwfl_round` directly.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ref import cwfl_round_ref

SOURCE = Path(__file__).with_name("csrc") / "cwfl_round.cu"
# The kernel keeps θ̃ and θ̄ of its column in registers, templated on C.
MAX_CLUSTERS = 16
# A block stages its trajectory's weights (C·K + C·C + K·C floats) in
# dynamic shared memory, which a launch gets up to 48 KiB of without an
# opt-in attribute; the bound holds per trajectory, whatever the batch.
_MAX_SHARED_BYTES = 48 * 1024

#: Kernel launches so far, unguarded and guarded; each raised by one per
#: launch of its variant, and nowhere else.
launches = 0
launches_guard = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for fn in (lib.cwfl_round_f32, lib.cwfl_round_bf16,
               lib.cwfl_round_guard_f32, lib.cwfl_round_guard_bf16):
        # s, a, n1, b, n2, m, out, cons, K, C, d, batch, stream
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(signals, phase1, noise1, phase2, noise2, broadcast):
    if signals.ndim not in (2, 3):
        raise ValueError(f"signals must be (K, d) or (B, K, d), got "
                         f"{tuple(signals.shape)}")
    lead = tuple(signals.shape[:-2])
    K, d = signals.shape[-2:]
    C = phase1.shape[-2]
    want = {"phase1": (C, K), "noise1": (C, d), "phase2": (C, C),
            "noise2": (C, d), "broadcast": (K, C)}
    want = {name: lead + shape for name, shape in want.items()}
    got = {"phase1": phase1, "noise1": noise1, "phase2": phase2,
           "noise2": noise2, "broadcast": broadcast}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for signals "
                             f"{(K, d)}, got {tuple(got[name].shape)}")
        if got[name].device != signals.device:
            raise ValueError(f"{name} is on {got[name].device}, signals on "
                             f"{signals.device}")
    if signals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"signals must be float32 or bfloat16, got "
                        f"{signals.dtype}")
    for name in ("noise1", "noise2"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {got[name].dtype}")


def cwfl_round(signals: torch.Tensor, phase1: torch.Tensor,
               noise1: torch.Tensor, phase2: torch.Tensor,
               noise2: torch.Tensor, broadcast: torch.Tensor,
               guard: bool = False):
    """One fused CWFL sync round over flat client signals.

    signals: (K, d) client parameter vectors (f32 or bf16; f32 sums).
    phase1:  (C, K) OTA MAC amplitudes Ã (precoded, normalized).
    noise1:  (C, d) f32 phase-1 receiver noise (pre-drawn).
    phase2:  (C, C) consensus mix B̃.
    noise2:  (C, d) f32 phase-2 equivalent receiver noise.
    broadcast: (K, C) phase-3 downlink matrix (``membership.T``).
    guard:   the guarded variant (non-finite S → 0, dead Ã rows → 0).
    Returns ``(new (K, d) in signals.dtype, consensus (d,) f32)``; with a
    leading trajectory axis B on every argument, ``(new (B, K, d),
    consensus (B, d))`` from one launch.
    """
    global launches, launches_guard
    _check(signals, phase1, noise1, phase2, noise2, broadcast)
    if signals.device.type == "cpu":
        return cwfl_round_ref(signals, phase1, noise1, phase2, noise2,
                              broadcast, guard=guard)
    if signals.device.type != "cuda":
        raise ValueError(f"cwfl_round runs on CUDA or the CPU, not "
                         f"{signals.device}")
    batch = signals.shape[0] if signals.ndim == 3 else 1
    K, d = signals.shape[-2:]
    C = phase1.shape[-2]
    if not 1 <= batch <= 65535:
        raise ValueError(f"the kernel takes 1..65535 trajectories, got "
                         f"{batch}")
    if not 1 <= C <= MAX_CLUSTERS:
        raise ValueError(f"the kernel takes 1..{MAX_CLUSTERS} clusters, "
                         f"got C={C}")
    if 4 * (2 * C * K + C * C) > _MAX_SHARED_BYTES:
        raise ValueError(f"K={K}, C={C}: the round weights exceed "
                         f"{_MAX_SHARED_BYTES} bytes of shared memory")
    if d >= 2 ** 31:
        raise ValueError(f"d = {d} does not fit the kernel's int sizes")
    for name, x in (("signals", signals), ("noise1", noise1),
                    ("noise2", noise2)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The weights are O(K·C): cast and pack them like the JAX wrapper does.
    a = phase1.to(torch.float32).contiguous()
    b = phase2.to(torch.float32).contiguous()
    m = broadcast.to(torch.float32).contiguous()
    new = torch.empty_like(signals)
    cons = torch.empty(signals.shape[:-2] + (d,), dtype=torch.float32,
                       device=signals.device)
    lib = _library()
    fn = getattr(lib, "cwfl_round_" + ("guard_" if guard else "")
                 + ("f32" if signals.dtype == torch.float32 else "bf16"))
    with torch.cuda.device(signals.device):
        err = fn(signals.data_ptr(), a.data_ptr(), noise1.data_ptr(),
                 b.data_ptr(), noise2.data_ptr(), m.data_ptr(),
                 new.data_ptr(), cons.data_ptr(), K, C, d, batch,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cwfl_round kernel launch failed: CUDA error "
                           f"{err} (B={batch}, K={K}, C={C}, d={d}, "
                           f"guard={guard})")
    if guard:
        launches_guard += 1
    else:
        launches += 1
    return new, cons


def hbm_bytes_model(K: int, C: int, d: int, itemsize: int = 4) -> dict:
    """Modeled device-memory traffic per sync round (weights are O(KC),
    negligible).

    Both variants must read S (K·d) + the two noise fields (2·C·d) and
    write new (K·d) + consensus (d).  The unfused three-pass round adds a
    write + read of θ̃ (2·C·d) and a write + two reads of θ̄ (3·C·d) —
    5·C·d extra scalars round-tripped through memory.
    """
    base = d * (2 * K + 2 * C + 1)
    return {
        "fused_bytes": itemsize * base,
        "unfused_bytes": itemsize * (base + 5 * C * d),
        "traffic_ratio": (base + 5 * C * d) / base,
    }
