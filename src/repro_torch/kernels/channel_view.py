"""One round of the channel process in XLA's CPU arithmetic: wrapper of
the Hopper kernel.

The JAX package steps its channel process and derives the round's view
(link gains, SNRs, the outage graph) in XLA's fused CPU loops
(`repro.sim.processes`); a cluster-head election on those SNRs turns on
their last ulp at a tie.  `channel_round` computes the step and the view
of a ``(..., K, K)`` stack of trajectories in one launch of
``csrc/channel_view.cu``, bit for bit the plain version
`repro_torch.core.xla_math.xla_channel_step` / `xla_channel_view`, which
are XLA's sequence (that module's docstring).  No Pallas twin: this is
new arithmetic, as the attention backward was.

On a CUDA tensor `channel_round` launches the kernel (built with ``nvcc``
at first use, see `repro_torch.kernels._build`) or raises; on a CPU
tensor it runs the plain version.  There is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.xla_math import xla_channel_step, xla_channel_view
from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).with_name("csrc") / "channel_view.cu"
#: The constants, in the kernel's ``Consts`` order.
CONST_ORDER = ("speed", "area", "rho", "innov_std", "rho_s", "shadow_std",
               "fade_fold", "shadow_fold", "inv_d0", "d0", "exponent",
               "inv20", "snr_scale", "outage_db")

#: Kernel launches so far: raised by one per launch, and nowhere else.
launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.channel_round_f32.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_void_p])
    lib.channel_round_f32.restype = ctypes.c_int
    return lib


def channel_round_ref(positions, waypoints, h_tilde, shadow_db, draws,
                      c: dict):
    """The plain version of `channel_round`."""
    h_re, h_im = h_tilde.real, h_tilde.imag
    if draws is not None:
        positions, waypoints, h_re, h_im, shadow_db = xla_channel_step(
            positions, waypoints, h_re, h_im, shadow_db, draws.fade_re,
            draws.fade_im, draws.shadow, draws.waypoints, c)
        h_tilde = torch.complex(h_re, h_im)
    g_re, g_im, snr, adj = xla_channel_view(positions, h_re, h_im,
                                            shadow_db, c)
    return (positions, waypoints, h_tilde, shadow_db,
            torch.complex(g_re, g_im), snr, adj)


def channel_round(positions: torch.Tensor, waypoints: torch.Tensor,
                  h_tilde: torch.Tensor, shadow_db: torch.Tensor,
                  draws: Optional[object], c: dict):
    """One round of the channel process over any leading axes.

    positions, waypoints: (..., K, 2) f32; h_tilde: (..., K, K) complex64;
    shadow_db: (..., K, K) f32; ``draws``: a `ChannelDraws` (fade_re,
    fade_im, shadow: (..., K, K) erf_inv values; waypoints (..., K, 2)
    uniforms), or None for the view of the state as it is; ``c``:
    `xla_math.channel_constants`.  Returns (positions, waypoints,
    h_tilde, shadow_db, link_gain, link_snr, adjacency), the state
    stepped (as given without ``draws``) and the view of it.
    """
    global launches
    dev = positions.device
    if dev.type == "cpu":
        return channel_round_ref(positions, waypoints, h_tilde, shadow_db,
                                 draws, c)
    if dev.type != "cuda":
        raise ValueError(f"channel_round runs on CUDA or the CPU, not {dev}")
    lead = tuple(positions.shape[:-2])
    K = positions.shape[-2]
    B = 1
    for n in lead:
        B *= n
    if not 1 <= B <= 2 ** 31 - 1 or K * K >= 2 ** 31:
        raise ValueError(f"the kernel takes 1..2^31-1 trajectories of "
                         f"K^2 < 2^31 links, got B={B}, K={K}")
    if h_tilde.dtype != torch.complex64:
        raise TypeError(f"h_tilde must be complex64, got {h_tilde.dtype}")

    def flat(x, dtype=torch.float32):
        return x.to(device=dev, dtype=dtype).contiguous()

    pos, way = flat(positions), flat(waypoints)
    h = torch.view_as_real(flat(h_tilde, torch.complex64)).contiguous()
    sh = flat(shadow_db)
    gain = torch.empty(lead + (K, K), dtype=torch.complex64, device=dev)
    snr = torch.empty(lead + (K, K), dtype=torch.float32, device=dev)
    adj = torch.empty(lead + (K, K), dtype=torch.bool, device=dev)
    if draws is None:
        step = 0
        fre = fim = fsh = wu = None
        outs = (pos, way, h_tilde, sh)
        ptrs_out = (None, None, None, None)
    else:
        step = 1
        fre, fim, fsh = (flat(draws.fade_re), flat(draws.fade_im),
                         flat(draws.shadow))
        wu = flat(draws.waypoints)
        new = (torch.empty_like(pos), torch.empty_like(way),
               torch.empty(lead + (K, K), dtype=torch.complex64,
                           device=dev), torch.empty_like(sh))
        outs = new
        ptrs_out = (new[0].data_ptr(), new[1].data_ptr(),
                    new[2].data_ptr(), new[3].data_ptr())
    consts = (ctypes.c_float * len(CONST_ORDER))(
        *(c[name] for name in CONST_ORDER))

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = _library().channel_round_f32(
            pos.data_ptr(), way.data_ptr(), h.data_ptr(), sh.data_ptr(),
            ptr(fre), ptr(fim), ptr(fsh), ptr(wu), *ptrs_out,
            gain.data_ptr(), snr.data_ptr(), adj.data_ptr(), K, B, step,
            ctypes.cast(consts, ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"channel_round kernel launch failed: CUDA error "
                           f"{err} (B={B}, K={K}, step={step})")
    launches += 1
    return outs + (gain, snr, adj)


def bytes_moved(B: int, K: int, step: bool = True,
                arrived: Optional[int] = None) -> int:
    """The least traffic of one launch: the state read once, the draws
    that the step uses read once (each link draw matrix's upper triangle
    with its diagonal, the lower one is its mirror; the waypoint uniforms
    of the ``arrived`` clients only, all B·K if None), the stepped state
    and the view written once."""
    links, clients = B * K * K, B * K
    read = links * (8 + 4) + clients * 8            # h, s; positions
    write = links * (8 + 4 + 1)                     # gains, SNRs, adjacency
    if step:
        drawn = B * K * (K + 1) // 2
        read += drawn * 12 + clients * 8            # three draws; way
        read += (clients if arrived is None else arrived) * 8    # way_u
        write += links * 12 + clients * 16          # h, s; positions, way
    return read + write
