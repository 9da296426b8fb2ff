"""The H100 roofline of the one-card dry run (port of `repro.launch.roofline`).

JAX derives three terms for each (arch × input shape) on a TPU v5e pod:
compute, memory and the collectives' traffic.  One card runs no
collective, so two terms remain, for the card the row ran on:

  compute = operations / peak rate of the step's dtype
  memory  = bytes that must move / memory rate

The peaks are the NVIDIA H100 SXM5 80GB HBM3 data sheet's (dense): 989
TFLOP/s bf16 and 495 TF32 on the tensor cores, 67 TFLOP/s f32 off them,
3.35 TB/s.  They hold at the card's 700 W power limit; a card set lower
runs slower under load, so a row carries the limit it ran at
(`repro_torch.launch.mesh.device_record`).

The operations: `torch.utils.flop_counter.FlopCounterMode` over the step on
the ``meta`` device (its matmuls); attention, which runs in the
hand-written kernels the counter does not see, from its unmasked (query,
key) pairs, 4·D operations each (a causal or windowed mask counts what it
keeps); the sLSTM's recurrence by `_slstm_flops`.  A training or prefill
step is counted at two sequence lengths and extended linearly to its own
(every counted term is linear in the positions once attention is apart),
which keeps the meta run short.  The bytes: JAX's `analytic_hbm_bytes` for
one chip — the parameters read once a pass (4 passes in training), 12
activation reads and writes of each position's d_model a layer (3× in
training), and a decode step's cache read once (the window's slots where
windowed), counted on the meta device.

Each row reports both terms, which bounds it, MFU (`model_flops` as the
step computes the model, `step_model_flops`, over the measured seconds
times the peak of the step's dtype) and the roofline share (the larger
term over the measured seconds).  A share over 1 would
be a counting error, and raises.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.transformer import count_active_params

# NVIDIA H100 SXM5 80GB HBM3, dense, at a 700 W power limit (data sheet).
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12            # B/s

# The two sequence lengths a training or prefill step is counted at
# (`_count_seq`).
COUNT_SEQ = (256, 512)


def _slstm_flops(cfg, shape) -> float:
    """Analytic flops of sLSTM layers (time-scan, invisible to unrolling)."""
    n_slstm = sum(1 for s in cfg.pattern if s.mixer == "slstm")
    n_slstm *= cfg.num_periods
    if n_slstm == 0:
        return 0.0
    d = cfg.d_model
    dh = d // cfg.num_heads
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    per_tok = 2 * 4 * d * dh + 40 * d      # 4 recurrent matvecs + gates
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd
    return n_slstm * tokens * per_tok * mult


def model_flops(arch: str, shape: InputShape) -> float:
    return model_flops_of(get_config(arch), shape)


def model_flops_of(cfg: ArchConfig, shape: InputShape) -> float:
    """6·N·tokens in training, 2·N·tokens in prefill, 2·N·B in decode, N
    the active parameters: JAX's `model_flops` of a configuration (a cut
    one included)."""
    n_active = count_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token


def step_model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """`model_flops_of` as the step computes the model: JAX's count takes
    every active parameter for 2 operations a token (6 in training), but
    the input embedding, unless tied to the LM head, is a lookup, and a
    prefill applies the LM head at the last position only.  At a depth
    cut to a layer or two these are most of the parameters (Kimi K2's one
    layer at prefill_32k: an MFU of 1.27 by JAX's count), so MFU is taken
    from this count."""
    table = cfg.vocab_size * cfg.d_model
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    per = 6.0 if shape.kind == "train" else 2.0
    out = model_flops_of(cfg, shape)
    if not cfg.tie_embeddings:
        out -= per * table * tokens
    if shape.kind == "prefill":
        out -= 2.0 * table * (tokens - shape.global_batch)
    return out


def unmasked_pairs(S: int, window: int = 0, causal: bool = True,
                   Skv: Optional[int] = None) -> int:
    """(query, key) pairs a head of S queries keeps: all S·Skv without the
    causal mask, else those of a causal head under a window (0: none)."""
    if not causal:
        return S * (S if Skv is None else Skv)
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """The attention kernels' operations in a training or prefill step:
    4·D a kept pair a head, each self-attention layer causal under its
    window, the audio encoder's bidirectional and the decoder's
    cross-attention on the encoder's positions.  Training runs each
    forward twice (remat) and the backward's five products (2.5
    forwards)."""
    if shape.kind == "decode":
        return 0.0       # plain torch: the counter sees it
    B, S = shape.global_batch, shape.seq_len
    per_pair = 4.0 * cfg.hd * cfg.num_heads
    pairs = sum(unmasked_pairs(S, s.window) for s in cfg.pattern
                if s.mixer == "attn") * cfg.num_periods
    enc = 0
    if cfg.frontend == "audio_stub":
        enc = cfg.encoder_layers * unmasked_pairs(cfg.encoder_seq,
                                                  causal=False)
        pairs += cfg.num_layers * S * cfg.encoder_seq
    flops = per_pair * B * (pairs + enc)
    if shape.kind == "train":
        fwd = 2.0 if cfg.remat else 1.0
        flops *= fwd + 2.5
    return flops


@contextlib.contextmanager
def _slstm_uncounted():
    """The sLSTM's per-token step without its recurrent matvecs, which
    `_slstm_flops` counts; the states keep their shapes."""
    from repro_torch.models import xlstm

    step = xlstm.slstm_step

    def uncounted(params, xw, state, num_heads):
        # The input and the recurrent weights stay in the graph (a
        # training step differentiates them) through elementwise ops and
        # a reduction, which the counter does not count.
        h = state[3] + 0.0 * (xw[:, :state[3].shape[1]] + params["r"].sum())
        return h, state[:3] + (h,)

    xlstm.slstm_step = uncounted
    try:
        yield
    finally:
        xlstm.slstm_step = step


def _counted(cfg: ArchConfig, shape: InputShape,
             window: Optional[int]) -> float:
    """Matmul operations of one step on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import (batch_specs, decode_cache_specs,
                                           meta_attention)
    from repro_torch.optim import sgd
    from repro_torch.training import dist_steps as ds
    from repro_torch.utils.pytree import tree_leaves

    B, S = shape.global_batch, shape.seq_len
    params = tfm.init_params(0, cfg, device="meta")
    with meta_attention(), _slstm_uncounted(), \
            FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            # M microbatches of B/M do the work of one of B.
            step = ds.make_train_step(cfg, shape, microbatches=1,
                                      donate=True)
            noise = [torch.empty_like(x) for x in tree_leaves(params)]
            step(params, sgd(1e-3).init(params),
                 batch_specs(cfg, S, B, "train"), noise)
        elif shape.kind == "prefill":
            with torch.no_grad():
                tfm.prefill(params, batch_specs(cfg, S, B, "prefill"), cfg)
        else:
            step = ds.make_decode_step(cfg, shape, window_override=window)
            caches = decode_cache_specs(step.cfg, B, S)
            with torch.no_grad():
                step(params, torch.empty((B, 1), dtype=torch.int64,
                                         device="meta"), caches, S - 1)
    return float(counter.get_total_flops())


def _count_seq(cfg: ArchConfig, batch: int) -> tuple:
    """`COUNT_SEQ`, or for an MoE configuration the first multiple of 256
    positions at which an expert's capacity is past its floor of 16 slots
    (`models.moe._capacity`): below it the experts' work does not grow
    with the positions, and a line through two floored counts would miss
    it."""
    s1 = COUNT_SEQ[0]
    if cfg.num_experts:
        need = 16 * cfg.num_experts / (cfg.top_k * cfg.capacity_factor
                                       * batch)
        s1 = max(s1, 256 * math.ceil(need / 256))
    return s1, 2 * s1


def step_flops(cfg: ArchConfig, shape: InputShape,
               window: Optional[int] = None, microbatches: int = 1) -> dict:
    """The step's operations: counted matmuls (extended linearly from two
    lengths, `_count_seq`, for training and prefill), attention and the
    sLSTM."""
    if shape.kind == "decode":
        counted = _counted(cfg, shape, window)
    else:
        s1, s2 = _count_seq(cfg, shape.global_batch)
        f1, f2 = (_counted(cfg, InputShape(shape.name, s, shape.global_batch,
                                           shape.kind), window)
                  for s in (s1, s2))
        counted = f1 + (shape.seq_len - s1) * (f2 - f1) / (s2 - s1)
    attn = attention_flops(cfg, shape)
    slstm = _slstm_flops(cfg, shape)
    return {"counted": counted, "attention": attn, "slstm": slstm,
            "total": counted + attn + slstm}


def analytic_hbm_bytes(cfg: ArchConfig, shape: InputShape,
                       window: Optional[int] = None) -> dict:
    """JAX's napkin model of a step's device-memory traffic on one chip:
    the parameters read once a pass (4 passes in training: forward,
    backward, the update's read and write), ~12 reads and writes of each
    position's d_model a layer (3× in training), and a decode step's cache
    read once (its bytes counted on the meta device: the window's slots
    where windowed)."""
    from repro_torch.launch.dryrun import _bytes, decode_cache_specs
    from repro_torch.training import dist_steps as ds

    E = torch.empty((), dtype=cfg.cdtype).element_size()
    params = _bytes(tfm.init_params(0, cfg, device="meta"))
    passes = 4.0 if shape.kind == "train" else 1.0
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    act_mult = 3.0 if shape.kind == "train" else 1.0
    act = 12.0 * cfg.num_layers * tokens * cfg.d_model * E * act_mult
    cache = 0
    if shape.kind == "decode":
        cache = _bytes(decode_cache_specs(ds.windowed_config(cfg, window),
                                          shape.global_batch,
                                          shape.seq_len))
    return {"params": params * passes, "activations": act, "cache": cache,
            "total": params * passes + act + cache}


def analyse(rec: dict, cfg: ArchConfig, shape: InputShape) -> dict:
    """The roofline of a row that ran: both terms, which bounds it, MFU
    and the share of the larger term in the measured seconds."""
    from repro_torch.launch.mesh import device_record

    dtype = cfg.compute_dtype
    peak = PEAK_FLOPS[dtype]
    flops = step_flops(cfg, shape, rec.get("window_override"),
                       rec.get("microbatches", 1))
    hbm = analytic_hbm_bytes(cfg, shape, rec.get("window_override"))
    t_compute = flops["total"] / peak
    t_memory = hbm["total"] / HBM_BW
    seconds = rec["run"]["step_s"]
    share = max(t_compute, t_memory) / seconds
    out = {"flops": flops, "hbm_bytes": hbm, "t_compute_s": t_compute,
           "t_memory_s": t_memory,
           "bound": "operations" if t_compute >= t_memory else "bytes",
           "model_flops": model_flops_of(cfg, shape),
           "mfu": step_model_flops(cfg, shape) / (seconds * peak),
           "share": share,
           "peak_flops": peak, "hbm_bw": HBM_BW,
           "card": device_record()}
    if share > 1.0:
        raise AssertionError(
            f"{rec['arch']} × {rec['shape']}: the roofline's {share:.3f} "
            f"of the measured {seconds} s is over 1, a counting error "
            f"({out})")
    return out
