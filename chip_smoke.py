#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device — the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, the TF32 flags;
2. build — ``nvcc`` builds every kernel of the port's paths from the
   sources in this checkout (into ``build/torch_kernels/``), one compiler
   for each source, all started together; then the same cold build one
   compiler after another, timed, into a scratch directory;
3. kernel — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the main paths and a few ragged ones, with its time, the
   plain version's time and the least time the card could take (its bound):
   ``cwfl_round`` (at the paper's MNIST width, at the CIFAR CNN's — K=27,
   d=698,250 — and at MNIST CWFL-4's C=4) and its guarded variant
   ``cwfl_round_guard``, the latter on signals with NaN and ±inf and a
   dead Ã row; ``ota_aggregate`` (the phase-1 OTA MAC) at the paper's
   MNIST width in f32 and bf16, at the shapes the baselines' syncs give
   it (FedAvg and COTAF: one row of weights, C=1, also at the CIFAR CNN's
   width; decentralized: C=K=50 rows), C=K=128 near the f32
   crossover of bytes and operations, JAX's ragged shape, and the shapes
   that take its other plans, each in one launch (counted), its output
   poisoned with NaN before each launch, with ``torch.addmm`` as its
   library yardstick; ``flash_attention`` (f32: the 3×TF32 wgmma + TMA
   kernel of ``flash_attention.cu``, its bound both on the tensor cores
   and on the CUDA cores; bf16: the wgmma + TMA kernel of
   ``flash_attention_sm90.cu``) at Gemma-2 9B's prefill shapes (f32 and
   bf16, local and global layers, with and without the softcap), a ragged
   GQA shape in each dtype, and a small shape for each head dim and
   dtype, its output poisoned with NaN before each launch; beside it one
   library call on the same inputs as a yardstick, held against the plain
   version too:
   ``flex_attention`` (compiled; the softcap as its ``score_mod``, the
   causal/window band as its block mask) where there is a softcap,
   ``scaled_dot_product_attention`` where there is none;
3a. batched — the trajectory axis of ``cwfl_round`` (B = 40 trajectories
   of the sweep's shape, and its guarded variant, both timed) and of
   ``ota_aggregate``
   (the COTAF sweep's B = 8, C = 1; B = 40; decentralized's C = K = 50 on
   the ring) against their plain versions, every output poisoned with NaN,
   each trajectory bitwise the unbatched launch on its inputs, timed with
   their bytes bounds and, for ``ota_aggregate``, ``torch.baddbmm`` (no
   time may lie under its bytes bound, here or in the kernel phase);
4. reference — small runs on the card against the same runs on the CPU,
   with the same draws: the static slice, ``flaky-clients``, a
   dead-cluster run whose faults kill whole clusters, each other strategy
   (``fedavg``, ``cotaf``, ``decentralized``, ``cwfl_prox``,
   ``cotaf_prox``) static and COTAF under ``flaky-clients``, the CIFAR
   CNN at 8×8×3 on a non-IID split (``cwfl``, and ``cotaf`` with
   µ_p = 0.1), and greedy decoding of the reduced Gemma-2 (its local
   window cut to 8) with the same weights;
5. slice — ``run_federated`` with CWFL on the static scenario at the full
   width of the paper's MNIST model (K=50 clients, C=3 clusters, the
   784-200-100-64-10 MLP, d=184,214) for a few rounds, with every kernel's
   launch count over that run (``cwfl_round`` once a round,
   ``ota_aggregate`` never);
6. dist — the distribution slice at the same width, on the slice's
   paper-static state and its params after one round of local training:
   ``phase1_ota_flat`` (the ``ota_aggregate`` kernel), ``cwfl_aggregate_
   flat`` and ``ota_aggregate_op`` on the card against the CPU and the
   tree route, ``make_fl_plan(50, 3)`` on the card against the CPU; then,
   in an NCCL process group of one rank (a ``file://`` store under
   ``build/``), ``hierarchical_ota_allreduce`` on a one-client plan and
   ``run_rounds(..., shard="clients")`` against the slice's run, looped
   and then scanned (the round's collectives captured in its graph), the
   scan bitwise the loop;
7. scenario — the same width under ``head-failure``, ``flaky-clients``,
   ``mobile-fading``, ``cluster-churn`` and ``straggler-heavy``: each
   fault round through the guarded kernel and no other, per-round live
   nodes, heads and mask mass, the test accuracy held to floors derived
   from the JAX package's runs; each run in loop mode, then in scan mode
   under the profiler (its launches counted there, its history the
   loop's);
7a. strategies — the same width with ``fedavg``, ``cotaf``,
   ``decentralized``, ``cwfl_prox`` and ``cotaf_prox``: the baselines'
   syncs through ``ota_aggregate`` (once a round, decentralized included),
   the prox variants' local objective, the
   round-5 accuracy held to floors from the JAX package's runs at the same
   width (``scripts/jax_strategy_reference.py``); each run in loop mode,
   then in scan mode as the scenarios are;
7b. quickstart — ``examples/quickstart_torch.main()`` on the card end to
   end (K=16, 12 rounds of ``cwfl`` and of ``fedavg``), its final
   accuracies held to floors from the JAX package's and the port's runs
   over 16 seeds, then its ``run`` on inputs made on the CPU against the
   same run on the CPU;
7c. paper — the CIFAR column of Table I (COTAF, COTAF-Prox, CWFL-3,
   CWFL-3-Prox: K=27, the CNN, d=698,250, non-IID) and MNIST CWFL-4 (K=50,
   C=4) through ``repro_torch.paper.common.run_setting`` at the paper's
   full scale, 3 rounds each: steady rounds/s, each kernel's launches,
   peak memory, and the round-3 accuracy against floors from the JAX
   package's runs (``scripts/jax_paper_reference.py``);
7d. trajectory — ``run_rounds`` in loop and scan mode in turns (the scan:
   an eager first round, then one CUDA graph a round, two kinds for a
   re-clustering scenario) at full width: paper-static (12 rounds),
   head-failure and cluster-churn (6), CIFAR CWFL-3 (3): steady rounds/s
   of each mode, the scan's history against the loop's (bitwise, or the
   FL gate with the kernels whose launches differ named), and over a
   profiled run of each mode the launches a round, the device's idle
   share and the round kernels' launches counted by the profiler (one a
   round; the wrappers' counters see only the warm-up and the captures);
   CIFAR's history, with cuDNN held to deterministic algorithms, bitwise
   loop against loop, scan against scan and scan against loop; then a
   paper-static run with and without the cuDNN flags, bitwise;
7e. monte_carlo — ``run_monte_carlo`` of the ``snr-sweep`` grid (8 seeds
   × 5 SNRs, 2,000 stacked clients) at MNIST width, 5 rounds, one batch
   through the batched ``cwfl_round``: trajectory-rounds/s against
   trajectories run one by one in scan mode (one a seed and an SNR), each
   held to its lone run (JAX's tolerances), the peak memory, the profiled
   launches;
   a COTAF sweep (8 seeds, 40 dB) through the batched ``ota_aggregate``;
   ``shard="mc"`` on one NCCL rank against the unsharded sweep;
7f. dynamic_sweep — ``run_monte_carlo`` under ``head-failure`` (8 seeds ×
   5 SNRs), ``cluster-churn`` (6 rounds), ``flaky-clients``, COTAF under
   ``head-failure`` and a dead-cluster scenario (8 seeds each) at MNIST
   width, each as one batch: trajectory-rounds/s against its lone scanned
   runs, each element bitwise its lone run (records included), the peak
   memory, the wrappers' calls against the profiler's launches (the
   batched guarded ``cwfl_round`` once a round in a fault sweep), and the
   dead Ã rows each round hands the kernel, counted on the device;
7g. obs — telemetry, checkpoints and the live stream at MNIST width:
   paper-static scanned with telemetry off and on (bitwise, steady
   rounds/s each, the round kernel once a round under the profiler; the
   card's telemetry against the CPU's on the same draws, `OBS_TOL`), with
   a `MemorySink` stream (every record bitwise the post-hoc telemetry),
   paper-static and head-failure stopped at a checkpoint and resumed
   (bitwise; each save's ms, a step directory's bytes), the head-failure
   8 × 5 sweep with telemetry (trajectory-rounds/s, peak memory, each
   element bitwise its lone telemetered run), COTAF and decentralized
   with telemetry, CIFAR CWFL-3 with telemetry (rounds/s, peak memory),
   and one NCCL rank client-sharded with telemetry and resume; the
   wrappers' calls on these runs go into the kernel rows as
   ``launches_obs``;
8. serve — ``greedy_decode`` of Gemma-2 9B at its published width (f32,
   random weights drawn on the card): 2 requests of 4,608-token prompts,
   16 greedy tokens; prefill seconds, decode tokens/s, the kernel's
   launches (one per layer in the prefill, none in decode), peak memory,
   and the last logits held against ``forward`` over the same tokens;
   one prefill and one decode step under ``torch.profiler``;
9. serve, bf16 — the same model and traffic with bf16 parameters and
   compute (the JAX package's serving dtypes), the f32 weights rounded:
   prefill seconds, decode ms a step, peak memory, the bf16 kernel's
   launches, one profiled prefill; then ``forward`` over the f32 serve's
   tokens through the kernel and through the plain version, the kernel's
   last logits no further from the f32 model's than SERVE_BF16_GATE
   times the plain version's;
9a. mixers — the configurations of the other mixers and front ends
   (MIXER_RUNS: ``qwen3-moe-235b-a22b`` and ``kimi-k2-1t-a32b``, MoE with
   qk_norm and Kimi's head dim 112 padded to 128; ``jamba-v0.1-52b``,
   mamba, MoE and attention; ``internvl2-2b``, the vision front end;
   ``whisper-tiny``, the audio encoder and cross-attention; ``xlstm-125m``,
   the mLSTM and sLSTM mixers): each reduced configuration's greedy
   decoding on the card against the CPU (same tokens, last logits within
   1e-4, the f32 kernel's launches as counted from the configuration),
   then ``greedy_decode`` of 16 tokens at the published widths (the MoE
   models and Jamba in bf16 with their depth cut, the rest whole in f32;
   ``phi4-mini-3.8b`` whole and ``llama3-405b`` at one layer, in bf16):
   prefill s, decode ms a step, peak memory, parameter bytes, the flash
   kernels' launches against the count from the configuration, and the
   gate, one prefill over the prompt and the decoded tokens against the
   decoded path's last logits; at every MoE and mamba run the
   cache-entry check (`cache_entry_check`: each entry the decode steps
   write against the one that prefill writes at the same position);
10. profile — under ``torch.profiler``, the static slice and
   ``head-failure``, the window on the rounds after the first, and one
   CIFAR CWFL-3 round at full width; device time by kernel (for CIFAR
   also by kind: grouped convolutions forward and backward, gemms, the
   round kernel), launches and the device's idle share;
11. lm_train — LM training: the attention backward kernel
   (``flash_attention_bwd.cu``) against its plain version at BWD_SHAPES
   (Qwen2.5-3B's and Gemma-2's layers, a ragged GQA shape, every head
   dim, f32 and bf16), on the forward kernels' own o and row statistics
   (their lse against the plain forward's, o bitwise the serve path's),
   every output poisoned with NaN, a second launch bitwise the first,
   timed against its bounds, the plain version and, at cap 0, SDPA's
   backward; the reduced Gemma-2 trained on the card against the CPU on
   the same params, tokens and noise (two shard-mode steps at M = 2, two
   replica steps at K = 4, C = 2 through ``cwfl_round``, one bf16 shard
   step); Qwen2.5-3B at full width, 3 shard-mode steps of 4 × 4,096
   tokens (the first CE near ln V, the second on the same batch lower;
   seconds a step, tokens/s, peak memory, 144 launches of each attention
   kernel a step, one profiled step); and
   ``examples/train_lm_cwfl_torch.py --steps 300`` under its gate; the
   backward's rows include the training geometries of the other mixers
   (G = 16, Kimi K2's head dim 112 padded, whisper's encoder without a
   mask and its cross-attention on 1,500 frames, Jamba's, InternVL2's
   and phi4-mini's layers), each timed beside SDPA's backward;
12. train — TRAIN_REDUCED: each reduced configuration's shard step on
   the card against the CPU (remat on against off and the donated step
   against the functional one, bitwise but for the embedding table):
   TRAIN_RUNS', Kimi K2's (also at its head dim of 112, padded to 128)
   and llama3-405b's; then TRAIN_RUNS: three donated shard-mode steps with remat, bf16, at the published
   width with the depth cut (Qwen3-MoE 4 layers, Jamba one period,
   InternVL2, whisper-tiny, xlstm-125m and phi4-mini-3.8b whole): seconds
   a step, tokens/s, peak memory, the attention kernels' launches against
   the count from the configuration, the loss finite and falling;
13. serve_twin — ``examples/serve_decode_torch.py`` (the serving builders
   ``make_prefill_step`` and ``make_decode_step``) with a serving-time
   window, card against CPU, at the reduced Qwen2.5-3B and at phi4-mini's
   published width.

The reference phase runs its card and CPU runs in loop mode (its count
of dead rows reads every sync on the host); the small CNN's reference
runs take the default scan, captured on the card.  The last two lines are
the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; it needs a CUDA device and has no CPU path.
"""
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of the H100 SXM (NVIDIA data sheet, dense): device-memory
# bytes/s, f32 FLOP/s outside the tensor cores, and bf16 and TF32 FLOP/s on
# the tensor cores, matched on the name the card reports.
PEAKS = (("H100 80GB HBM3", 3.35e12, 67e12, 989e12, 495e12),)

DEVICE = "cuda"
F32_ATOL = 1e-5          # f32 sums in another order than cuBLAS's
BF16_ULP_REL = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


# The card's name and power limit (``nvidia-smi``), set by ``main``.
CARD = []


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the card's name and power
    limit beside its numbers, and the seconds since the script started."""
    if "phase" in obj and CARD:
        obj = {**obj, "card": CARD[0],
               "t_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    """(bytes/s, f32 FLOP/s, bf16 FLOP/s, TF32 FLOP/s) of the card called
    ``name``."""
    for key, *peaks in PEAKS:
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}; add them to PEAKS")


def time_cold(fn, reps: int = 30, flush_bytes: int = 256 << 20) -> float:
    """Median ms of ``fn()`` on the card, CUDA events around each call,
    with the 50 MB L2 flushed before each (the round's working set is
    larger than L2 anyway)."""
    flush = torch.empty(flush_bytes // 4, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def device_ms(fn, reps: int = 20, flush_bytes: int = 256 << 20) -> float:
    """Median device ms of ``fn()``, the L2 flushed before each call: CUDA
    events around the call, recorded while the device still spins on a
    wait of about a millisecond (``torch.cuda._sleep``) that lets the host
    enqueue the whole call first, so the events time the device's work
    and not the host's launch.  (Not the profiler: it has dropped kernel
    records, 8 of 10 launches of the batched ``cwfl_round`` in one run,
    which read as a time under the bytes bound.)  A host slower than the
    wait could only lengthen the reading, never shorten it."""
    flush = torch.empty(flush_bytes // 4, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def above_bound(label: str, times: dict, bound_ms: float) -> None:
    """No time in ``times`` lies under ``bound_ms``, the least time the
    card could take: one that did would be a fault of the measurement."""
    under = {k: v for k, v in times.items() if v < bound_ms}
    if under:
        raise AssertionError(f"{label}: timed under its bytes bound of "
                             f"{bound_ms} ms: {under}")


def round_inputs(K: int, C: int, d: int, dtype, seed: int):
    """Inputs shaped as the main path makes them: row-stochastic Ã and B̃
    (the normalized phase weights), a membership-like downlink M, unit
    normal signals and small receiver noise."""
    g = torch.Generator(DEVICE).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=DEVICE)

    a = rand(C, K)
    b = rand(C, C)
    m = torch.nn.functional.one_hot(
        torch.randint(C, (K,), generator=g, device=DEVICE), C).float()
    s = torch.randn(K, d, generator=g, device=DEVICE).to(dtype)
    n1 = 1e-2 * torch.randn(C, d, generator=g, device=DEVICE)
    n2 = 1e-2 * torch.randn(C, d, generator=g, device=DEVICE)
    return (s, a / a.sum(1, keepdim=True), n1, b / b.sum(1, keepdim=True),
            n2, m)


def poison(args, seed: int):
    """A fault round's inputs: about 1% of S NaN or ±inf, and the last Ã
    row dead (all zero, its noise left on)."""
    s, a, n1, b, n2, m = args
    g = torch.Generator(DEVICE).manual_seed(seed)
    bad = torch.rand(s.shape, generator=g, device=DEVICE) < 0.01
    kind = torch.randint(3, s.shape, generator=g, device=DEVICE)
    vals = torch.tensor([math.nan, math.inf, -math.inf], device=DEVICE)
    s = torch.where(bad, vals[kind].to(s.dtype), s)
    a = a.clone()
    a[-1] = 0.0
    return s, a, n1, b, n2, m


# cwfl_round at the shapes the main paths give it: the paper's MNIST width
# (K=50, C=3, d=184,214), the CIFAR CNN's (K=27, C=3, d=698,250, ≡ 2 mod
# 4: every other f32 row 8 bytes off a 16-byte boundary) and MNIST CWFL-4
# (C=4); a ragged and a tiny shape, and bf16 signals.  The rows of the
# kernels summary: the shape label and the row's name (the guarded
# variant's: its MNIST row only, the fault scenarios' shape).
CWFL_SHAPES = (
    # label, K, C, d, signals dtype
    ("main", 50, 3, 184214, torch.float32),
    ("cifar", 27, 3, 698250, torch.float32),
    ("mnist_c4", 50, 4, 184214, torch.float32),
    ("ragged", 16, 4, 2049, torch.float32),
    ("tiny", 1, 1, 700, torch.float32),
    ("main_bf16", 50, 3, 184214, torch.bfloat16),
)
CWFL_ROWS = (("main", ""), ("cifar", "[cifar]"), ("mnist_c4", "[C=4]"))


def kernel_phase(kmod, ref_fn, guard: bool = False):
    """cwfl_round (or its guarded variant, on poisoned inputs) against its
    plain version at CWFL_SHAPES; returns the rows of the kernels summary
    (without their launch counts) for CWFL_ROWS, the guarded variant's
    for its main shape."""
    name = "cwfl_round_guard" if guard else "cwfl_round"
    timed = dict(CWFL_ROWS[:1] if guard else CWFL_ROWS)
    rows = []
    for label, K, C, d, dtype in CWFL_SHAPES:
        args = round_inputs(K, C, d, dtype, seed=K + C + d)
        if guard:
            args = poison(args, seed=K + C + d)
        new, cons = kmod.cwfl_round(*args, guard=guard)
        ref_new, ref_cons = ref_fn(*args, guard=guard)
        torch.cuda.synchronize()
        assert new.dtype == dtype and new.shape == (K, d)
        assert cons.dtype == torch.float32 and cons.shape == (d,)
        diff = (new.float() - ref_new.float()).abs()
        err_new, err_cons = float(diff.max()), float(
            (cons - ref_cons).abs().max())
        if dtype == torch.float32:
            ok_new = err_new <= F32_ATOL
            tol_new = f"abs {F32_ATOL}"
        else:
            ok_new = bool(torch.all(
                diff <= BF16_ULP_REL * ref_new.float().abs() + F32_ATOL))
            tol_new = f"one bf16 ulp (2^-7 rel) + abs {F32_ATOL}"
        finite = bool(torch.isfinite(new.float()).all()
                      and torch.isfinite(cons).all())
        line = {"phase": "kernel", "kernel": name, "shape": label,
                "K": K, "C": C, "d": d, "dtype": str(dtype),
                "max_abs_err_new": err_new, "tol_new": tol_new,
                "max_abs_err_cons": err_cons, "tol_cons": F32_ATOL,
                "finite": finite}
        if label in timed:
            bw, peak, *_ = card_peaks(torch.cuda.get_device_name(0))
            nbytes = (kmod.hbm_bytes_model(K, C, d)["fused_bytes"]
                      + 4 * (2 * C * K + C * C))
            flops = d * (2 * C * K + 2 * C * C + 2 * K * C + 3 * C)
            bound_bytes, bound_ops = nbytes / bw * 1e3, flops / peak * 1e3
            launch = lambda: kmod.cwfl_round(*args, guard=guard)  # noqa: E731
            plain = lambda: ref_fn(*args, guard=guard)            # noqa: E731
            ms = time_cold(launch)
            plain_ms = time_cold(plain)
            line.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
                        bound_ms_bytes=bound_bytes,
                        bound_ms_operations=bound_ops,
                        achieved_bytes_per_s=nbytes / (ms * 1e-3),
                        device_ms=device_ms(launch),
                        plain_device_ms=device_ms(plain))
            above_bound(f"{name}[{label}]", {k: line[k] for k in (
                "ms", "plain_ms", "device_ms", "plain_device_ms")},
                bound_bytes)
            rows.append({"name": name + timed[label], "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "cwfl_round.cu",
                         "replaces": ("src/repro/kernels/cwfl_round.py:124"
                                      if guard else
                                      "src/repro/kernels/cwfl_round.py:42"),
                         "launches": None,
                         "max_abs_err": max(err_new, err_cons),
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": max(bound_bytes, bound_ops),
                         "bound_by": ("bytes" if bound_bytes >= bound_ops
                                      else "operations"),
                         "library_ms": None,
                         "device_ms": line["device_ms"],
                         "plain_device_ms": line["plain_device_ms"],
                         "shape": {"K": K, "C": C, "d": d}})
        emit(line)
        if not (ok_new and err_cons <= F32_ATOL and (finite or not guard)):
            raise AssertionError(f"{name} disagrees with its plain "
                                 f"version at {label}: {line}")
    return rows


# ota_aggregate at the shape phase 1 gives it at the paper's MNIST width
# (K=50 clients, C=3 clusters, d=184,214) in f32 and in bf16 (weights and
# noise in the signals' dtype, as JAX's tests pass them), at the shapes the
# baselines' syncs give it at that width (FedAvg and COTAF: one row of
# weights; decentralized: K=50 rows), at COTAF's shape at the CIFAR CNN's
# width (K=27, d=698,250), at C=K=128 (near the f32 crossover
# of bytes and operations: two passes of 64 rows over a resident tile),
# JAX's ragged shape with f32 and with bf16 signals (f32 noise: the mixed
# instantiation), and the shapes that take the kernel's other plans: 20
# rows on the ring in blocks of 4, with misaligned rows (d odd) and with
# every row on a 16-byte boundary (nothing to realign), K=1,000 streamed
# through shared memory in chunks, 256 rows in passes (with K=50, and with
# K=1,000 in bf16), decentralized consensus past 256 clients, FedAvg with
# 2,000 clients, and the column path with 224 KB of weights in shared
# memory.  Every shape is one launch.
OTA_SHAPES = (
    # label, K, C, d, signals dtype, weights and noise dtype
    ("main", 50, 3, 184214, torch.float32, torch.float32),
    ("main_bf16", 50, 3, 184214, torch.bfloat16, torch.bfloat16),
    ("fedavg_cotaf", 50, 1, 184214, torch.float32, torch.float32),
    ("cotaf_cifar", 27, 1, 698250, torch.float32, torch.float32),
    ("decentralized", 50, 50, 184214, torch.float32, torch.float32),
    ("decentralized_k128", 128, 128, 184214, torch.float32, torch.float32),
    ("ragged", 16, 4, 2049, torch.float32, torch.float32),
    ("ragged_bf16_f32noise", 16, 4, 2049, torch.bfloat16, torch.float32),
    ("many_clusters", 40, 20, 3001, torch.float32, torch.float32),
    ("aligned_rows", 40, 20, 4096, torch.float32, torch.float32),
    ("wide_k", 1000, 16, 777, torch.float32, torch.float32),
    ("most_rows", 50, 256, 1001, torch.float32, torch.float32),
    ("rows_256_k1000_bf16", 1000, 256, 515, torch.bfloat16, torch.float32),
    ("decentralized_k300", 300, 300, 1001, torch.float32, torch.float32),
    ("fedavg_k2000", 2000, 1, 3001, torch.bfloat16, torch.float32),
    ("column_wide_w", 7000, 8, 1500, torch.float32, torch.float32),
)
# The JAX package's tolerances for this kernel (tests/test_kernels.py),
# absolute and relative: f32 sums in another order; bf16 outputs.
OTA_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def poisoned_launch(fn, out_shape, dtype):
    """``fn()``, whose output of ``out_shape`` is allocated into memory
    filled with NaN just before: an element the kernel does not write
    stays NaN.  The caching allocator hands the wrapper's ``torch.empty``
    the block just freed (its cache emptied first, so that block is the
    only free one); the output's address proves it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bait = torch.full(out_shape, math.nan, dtype=dtype, device=DEVICE)
    ptr = bait.data_ptr()
    del bait
    out = fn()
    if out.data_ptr() != ptr:
        raise AssertionError("the output was not allocated into the "
                             "poisoned block; the check would prove nothing")
    return out


# The rows of the kernels summary: the shape, and the row's name.
OTA_ROWS = (("main", "ota_aggregate"),
            ("fedavg_cotaf", "ota_aggregate[C=1]"),
            ("decentralized", "ota_aggregate[C=50]"),
            ("cotaf_cifar", "ota_aggregate[cifar C=1]"))
# The shapes that are timed.
OTA_TIMED = ("main", "main_bf16", "fedavg_cotaf", "cotaf_cifar",
             "decentralized", "decentralized_k128", "ragged")


def ota_inputs(K, C, d, dtype, wdtype):
    """Signals, row-stochastic weights and small noise, from a seed of
    the shape."""
    g = torch.Generator(DEVICE).manual_seed(K + C + d)
    s = torch.randn(K, d, generator=g, device=DEVICE).to(dtype)
    w = torch.rand(C, K, generator=g, device=DEVICE)
    w = (w / w.sum(1, keepdim=True)).to(wdtype)
    n = (1e-2 * torch.randn(C, d, generator=g, device=DEVICE)).to(wdtype)
    return s, w, n


def ota_bounds(s, n, C):
    """(bytes, flops, bound ms by bytes, by operations): read S and N
    once, write y once (W is O(C·K)); 2·C·K + C f32 operations a column on
    the CUDA cores."""
    bw, peak_f32, *_ = card_peaks(torch.cuda.get_device_name(0))
    K, d = s.shape
    nbytes = (s.numel() * s.element_size() + n.numel() * n.element_size()
              + C * d * s.element_size() + 4 * C * K)
    flops = d * (2 * C * K + C)
    return nbytes, flops, nbytes / bw * 1e3, flops / peak_f32 * 1e3


def ota_kernel_phase(omod, ref_fn):
    """ota_aggregate against its plain version at OTA_SHAPES, with
    ``torch.addmm(N, W, S)`` — one cuBLAS call computing the same function
    (TF32 off) — beside it; returns the rows of the kernels summary for
    OTA_ROWS (without their launch counts)."""
    rows = {}
    for label, K, C, d, dtype, wdtype in OTA_SHAPES:
        s, w, n = ota_inputs(K, C, d, dtype, wdtype)
        ref = ref_fn(s, w, n)
        before = omod.launches
        out = poisoned_launch(lambda: omod.ota_aggregate(s, w, n), (C, d),
                              dtype)
        torch.cuda.synchronize()
        a_call = omod.launches - before
        tol = OTA_TOL[dtype]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool(torch.all(diff <= tol + tol * ref.float().abs()))
        line = {"phase": "kernel", "kernel": "ota_aggregate", "shape": label,
                "K": K, "C": C, "d": d, "dtype": str(dtype),
                "weights_noise_dtype": str(wdtype),
                "launches_a_call": a_call,
                "max_abs_err": err, "tol_abs_and_rel": tol,
                "finite": bool(torch.isfinite(out.float()).all())}
        if label in OTA_TIMED:
            nbytes, flops, bound_bytes, bound_ops = ota_bounds(s, n, C)
            ms = time_cold(lambda: omod.ota_aggregate(s, w, n))
            plain_ms = time_cold(lambda: ref_fn(s, w, n))
            wl = w.to(dtype)
            lib = lambda: torch.addmm(n.to(dtype), wl, s)   # noqa: E731
            lib_err = float((lib().float() - ref.float()).abs().max())
            line.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
                        bound_ms_bytes=bound_bytes,
                        bound_ms_operations=bound_ops,
                        achieved_bytes_per_s=nbytes / (ms * 1e-3),
                        device_ms=device_ms(
                            lambda: omod.ota_aggregate(s, w, n)),
                        plain_device_ms=device_ms(lambda: ref_fn(s, w, n)),
                        library="torch.addmm", library_max_abs_err=lib_err,
                        library_ms=time_cold(lib),
                        library_device_ms=device_ms(lib))
            above_bound(f"ota_aggregate[{label}]", {k: line[k] for k in (
                "ms", "plain_ms", "device_ms", "plain_device_ms", "library_ms",
                "library_device_ms")}, bound_bytes)
            rows[label] = line
        emit(line)
        if not (ok and line["finite"]):
            raise AssertionError(f"ota_aggregate disagrees with its plain "
                                 f"version at {label}: {line}")
        if a_call != 1:
            raise AssertionError(f"ota_aggregate made {a_call} launches at "
                                 f"{label}, expected 1")
        if line.get("library_max_abs_err", 0.0) > tol:
            raise AssertionError(f"the library yardstick computes another "
                                 f"function at {label}: {line}")
    summary = []
    for label, name in OTA_ROWS:
        line = rows[label]
        summary.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ota_aggregate.cu",
            "replaces": "src/repro/kernels/ota_aggregate.py:38",
            "launches": None, "max_abs_err": line["max_abs_err"],
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": max(line["bound_ms_bytes"],
                            line["bound_ms_operations"]),
            "bound_by": ("bytes" if line["bound_ms_bytes"]
                         >= line["bound_ms_operations"] else "operations"),
            "library_ms": line["library_ms"], "library": "torch.addmm",
            "device_ms": line["device_ms"],
            "plain_device_ms": line["plain_device_ms"],
            "library_device_ms": line["library_device_ms"],
            "shape": {"K": line["K"], "C": line["C"], "d": line["d"]}})
    bf16 = rows["main_bf16"]
    summary[0].update(
        ms_bf16=bf16["ms"], device_ms_bf16=bf16["device_ms"],
        plain_ms_bf16=bf16["plain_ms"],
        bound_ms_bf16=max(bf16["bound_ms_bytes"],
                          bf16["bound_ms_operations"]),
        library_ms_bf16=bf16["library_ms"])
    return summary


def dead_cluster_scenario(crash: float = 0.6, recover: float = 0.2):
    """Crashes frequent and recoveries rare enough that whole clusters die
    (their Ã rows go to 0): at K = 8 the defaults; at K = 50, where a
    cluster has some 17 members, crash 0.9 and recover 0.05 (about one
    node in twenty up)."""
    from repro_torch.sim import FaultConfig, Scenario

    return Scenario(name="dead-cluster",
                    faults=FaultConfig(crash_prob=crash,
                                       recover_prob=recover))


def small_workload(device):
    from repro_torch.core import TopologyConfig, make_topology
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_iid)

    K = 8
    topo = make_topology(7, TopologyConfig(num_clients=K), device="cpu")
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        0, SyntheticImageConfig.mnist_like(1920, 256), device="cpu")
    xs, ys = partition_iid(1, xtr, ytr, K)
    return topo.to(device), xs.to(device), ys.to(device), xte.to(device), \
        yte.to(device)


def count_dead_rows(run):
    """``run()``, with the number of dead Ã rows (Σ|Ã row| = 0: a cluster
    whose every member failed) that each sync handed the round kernel."""
    from repro_torch.core import cwfl

    launch, seen = cwfl.cwfl_round, []

    def counting(signals, phase1, *args, **kwargs):
        seen.append(int((phase1.abs().sum(dim=1) <= 0).sum()))
        return launch(signals, phase1, *args, **kwargs)

    cwfl.cwfl_round = counting
    try:
        return run(), seen
    finally:
        cwfl.cwfl_round = launch


def reference_phase(label: str, scenario=None, rounds: int = 3,
                    draws_seed: int = 0, strategy: str = "cwfl"):
    """A small run of ``strategy`` on the card against the same run on the
    CPU, with the same draws (made on the CPU) and data: K=8, hidden 32.
    Returns the dead Ã rows each round of the card's run handed the CWFL
    round kernel."""
    from repro_torch.core import TopologyConfig
    from repro_torch.models import make_mnist_mlp, nll_loss
    from repro_torch.sim import TorchDraws
    from repro_torch.training import FLConfig, run_federated
    from repro_torch.utils import tree_leaves

    init, apply = make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: nll_loss(apply(p, x), y)   # noqa: E731
    cfg = FLConfig(strategy=strategy, rounds=rounds, eval_samples=256,
                   lr=0.05)
    runs, dead = {}, {}
    for dev in (DEVICE, "cpu"):
        runs[dev], dead[dev] = count_dead_rows(lambda: run_federated(
            init, apply, loss, *small_workload(dev), cfg,
            scenario=scenario, topo_cfg=TopologyConfig(num_clients=8),
            draws=TorchDraws(draws_seed, "cpu"), device=dev, mode="loop"))
    gpu, cpu = runs[DEVICE], runs["cpu"]
    loss_rel = max(abs(a / b - 1) for a, b in zip(gpu["train_loss"],
                                                   cpu["train_loss"]))
    param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(gpu["final_params"]), tree_leaves(cpu["final_params"])))
    acc_err = max(abs(a - b) for a, b in zip(gpu["test_acc"],
                                            cpu["test_acc"]))
    line = {"phase": "reference", "run": label, "strategy": strategy,
            "train_loss_cuda": gpu["train_loss"],
            "train_loss_cpu": cpu["train_loss"], "loss_rel_err": loss_rel,
            "tol_loss_rel": 1e-4, "test_acc_cuda": gpu["test_acc"],
            "test_acc_cpu": cpu["test_acc"], "acc_abs_err": acc_err,
            "tol_acc_abs": 2 / 256, "param_abs_err": param_err,
            "tol_param_abs": 1e-4, "dead_rows_cuda": dead[DEVICE],
            "dead_rows_cpu": dead["cpu"],
            "scenario_cuda": gpu.get("scenario"),
            "scenario_cpu": cpu.get("scenario")}
    emit(line)
    if not all(math.isfinite(x) for x in gpu["train_loss"]):
        raise AssertionError(f"non-finite train loss on the card: {line}")
    if not (loss_rel <= 1e-4 and acc_err <= 2 / 256 and param_err <= 1e-4
            and gpu.get("scenario") == cpu.get("scenario")
            and dead[DEVICE] == dead["cpu"]):
        raise AssertionError(f"the {label} run on the card disagrees with "
                             f"the CPU: {line}")
    return dead[DEVICE]


def full_width_workload():
    """The paper's MNIST setting: K=50 clients, the 784-200-100-64-10 MLP,
    the 60,000/10,000 mnist-like set split IID, and a 50-client topology."""
    from repro_torch.core import TopologyConfig, make_topology
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_iid)
    from repro_torch.models import make_mnist_mlp, nll_loss

    K = 50
    topo = make_topology(0, TopologyConfig(num_clients=K), device=DEVICE)
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        1, SyntheticImageConfig.mnist_like(), device=DEVICE)
    xs, ys = partition_iid(2, xtr, ytr, K)
    init, apply = make_mnist_mlp(hidden=(200, 100, 64))
    loss = lambda p, x, y: nll_loss(apply(p, x), y)   # noqa: E731
    return init, apply, loss, topo, xs, ys, xte, yte


def slice_phase(kmod, omod, rounds: int = 5):
    """run_federated at the paper's MNIST width on the card: one
    ``cwfl_round`` launch a round and no ``ota_aggregate`` launch."""
    from repro_torch.training import FLConfig, run_federated
    from repro_torch.utils import tree_size

    t0 = time.perf_counter()
    init, apply, loss, topo, xs, ys, xte, yte = full_width_workload()
    K = int(xs.shape[0])
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    stamps = []

    def progress(r, l, a):
        stamps.append(time.perf_counter())
        emit({"phase": "slice", "round": r, "train_loss": l, "test_acc": a})

    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.launches_guard = omod.launches = 0
    t0 = time.perf_counter()
    h = run_federated(init, apply, loss, topo, xs, ys, xte, yte, cfg,
                      progress=progress, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_guard = kmod.launches, kmod.launches_guard
    ota_launches = omod.launches

    d = tree_size(h["final_params"])
    steady = (stamps[-1] - stamps[0]) / (rounds - 1)
    line = {"phase": "slice", "K": K, "C": cfg.num_clusters, "d": d,
            "n_k": int(xs.shape[1]), "rounds": rounds,
            "data_setup_s": setup_s, "wall_s": wall,
            "rounds_per_s": rounds / wall,
            "steady_rounds_per_s": 1.0 / steady,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "cwfl_round_launches": launches,
            "cwfl_round_guard_launches": launches_guard,
            "ota_aggregate_launches": ota_launches,
            "train_loss": h["train_loss"], "test_acc": h["test_acc"]}
    emit(line)
    if d != 184214:
        raise AssertionError(f"flat dimension {d}, expected 184214")
    if launches != rounds or launches_guard != 0 or ota_launches != 0:
        raise AssertionError(f"cwfl_round launched {launches} times, its "
                             f"guarded variant {launches_guard} and "
                             f"ota_aggregate {ota_launches} in {rounds} "
                             f"static rounds")
    if not all(math.isfinite(x) for x in h["train_loss"]):
        raise AssertionError(f"non-finite train loss {h['train_loss']}")
    if not h["train_loss"][-1] < h["train_loss"][0]:
        raise AssertionError(f"train loss did not fall: {h['train_loss']}")
    if not h["test_acc"][-1] >= 0.7:
        raise AssertionError(f"last-round test accuracy "
                             f"{h['test_acc'][-1]} < 0.7")
    return launches, h


def state_to(state, device):
    """A `CWFLState` with its tensors on ``device``."""
    import dataclasses

    def moved(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return dataclasses.replace(moved(state), plan=moved(state.plan))


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, both on the CPU in f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def dist_phase(omod, kmod, static, rounds: int = 5) -> int:
    """The distribution slice at the paper's MNIST width, on the slice
    phase's paper-static state (the same draws) and its K-stacked params
    after one round of local training; returns ``ota_aggregate``'s
    launches on this path (one per call that reaches it, counted from 0).

    ``phase1_ota_flat``, ``cwfl_aggregate_flat`` and ``ota_aggregate_op``
    run on the card, then again on the CPU (or through the tree route) on
    the same inputs and unit normals; ``make_fl_plan(50, 3)`` runs on the
    card and on the CPU from the same topology and first centre.  Then an
    NCCL process group of one rank: NCCL takes one rank a device, and
    this card is one rank.  In it ``hierarchical_ota_allreduce`` runs on a
    one-client plan (against the same call over a gloo group of the CPU),
    and ``run_rounds(..., shard="clients")`` reruns the slice's run, in
    loop mode, then in the default scan (the round and its collectives
    captured: an eager round, then one CUDA graph a round), timed by
    `PhaseTimers` and once more under the profiler: the loop's loss and
    accuracy must agree with the unsharded run within the JAX package's
    own tolerances (tests/test_sim_sharded.py), the scan's history must
    equal the loop's bit for bit, and whether it is bitwise the unsharded
    run's is reported (the sharded sync's products are plain matmuls,
    not the fused round kernel)."""
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TopologyConfig, cwfl, make_topology
    from repro_torch.obs import PhaseTimers
    from repro_torch.dist import fl_integration as fl
    from repro_torch.dist import ota_collectives as oc
    from repro_torch.kernels.ops import ota_aggregate_op
    from repro_torch.optim import sgd
    from repro_torch.sim import TorchDraws, run_rounds
    from repro_torch.strategies import get_strategy
    from repro_torch.training import FLConfig
    from repro_torch.training.local import make_local_runner
    from repro_torch.utils import tree_leaves, tree_map, tree_size

    workload = full_width_workload()
    init, _, loss, topo, xs, ys, _, _ = workload
    K, n_k = int(xs.shape[0]), int(xs.shape[1])
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    draws = TorchDraws(cfg.seed, DEVICE)
    state = get_strategy("cwfl").init(topo, draws, cfg, snr_db=cfg.snr_db)
    params = draws.init_params(init)
    stacked = tree_map(lambda x: x.expand((K,) + x.shape).clone(), params)
    steps = n_k // cfg.batch_size
    opt = sgd(cfg.lr)
    local_run = make_local_runner(loss, opt, cfg.batch_size, steps)
    stacked, _, _ = local_run(stacked, opt.init(stacked), xs, ys,
                              draws.batch_indices(0, K, steps,
                                                  cfg.batch_size, n_k))
    d = tree_size(params)
    flat = torch.cat([x.reshape(K, -1) for x in tree_leaves(stacked)], 1)
    unit1, unit2 = draws.phase_noise(0, cfg.num_clusters, d)
    a, eff_std, _, _, _ = cwfl.round_coefficients(state, flat)
    op_std = float(eff_std.mean())

    # The path: every call that reaches a kernel, counted from 0.
    torch.cuda.synchronize()
    omod.launches = kmod.launches = 0
    y = oc.phase1_ota_flat(flat, state, unit1)
    new, cons = oc.cwfl_aggregate_flat(flat, state, (unit1, unit2))
    per_cluster = ota_aggregate_op(stacked, a, unit1, op_std)
    torch.cuda.synchronize()
    launches = {"ota_aggregate": omod.launches, "cwfl_round": kmod.launches}

    cpu = state_to(state, "cpu")
    y_cpu = oc.phase1_ota_flat(flat.cpu(), cpu, unit1.cpu())
    tree_new, tree_cons = cwfl.aggregate(stacked, state, (unit1, unit2))
    per_cluster_cpu = ota_aggregate_op(tree_map(lambda x: x.cpu(), stacked),
                                       a.cpu(), unit1.cpu(), op_std)
    errs = {
        "phase1_ota_flat_vs_cpu_rel": rel_err(y, y_cpu),
        "cwfl_aggregate_flat_vs_tree_abs": max(
            float((new - torch.cat([x.reshape(K, -1) for x in
                                    tree_leaves(tree_new)], 1)).abs().max()),
            float((cons - torch.cat([x.reshape(-1) for x in
                                     tree_leaves(tree_cons)])).abs().max())),
        "ota_aggregate_op_vs_cpu_rel": max(
            rel_err(g, c) for g, c in zip(tree_leaves(per_cluster),
                                          tree_leaves(per_cluster_cpu)))}
    shapes_ok = (tuple(y.shape) == (cfg.num_clusters, d)
                 and all(tuple(g.shape) == (cfg.num_clusters,) + p.shape
                         for g, p in zip(tree_leaves(per_cluster),
                                         tree_leaves(params))))

    # The FL plan, on the card and on the CPU from the same draws.
    topo_cpu = make_topology(0, TopologyConfig(num_clients=K), device="cpu")
    plans = {dev: fl.make_fl_plan(K, 3, topology=topo_cpu,
                                  draws=TorchDraws(0, "cpu"), device=dev)
             for dev in (DEVICE, "cpu")}
    own = fl.make_fl_plan(K, 3, seed=0, device=DEVICE)
    plan_ok = (np.array_equal(plans[DEVICE].assignment,
                              plans["cpu"].assignment)
               and np.array_equal(plans[DEVICE].heads, plans["cpu"].heads))
    errs["make_fl_plan_beta_rel"] = rel_err(
        *(torch.from_numpy(plans[dev].beta) for dev in (DEVICE, "cpu")))
    errs["make_fl_plan_noise_std_rel"] = abs(
        plans[DEVICE].noise_std / plans["cpu"].noise_std - 1)

    # The collectives, in an NCCL group of one rank.
    store = ROOT / "build" / f"dist-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        gloo = dist.new_group(backend="gloo")
        plan1 = fl.make_fl_plan(1, 1, seed=0, device=DEVICE)
        noise1 = (unit1[:1], unit2[:1])
        x = flat[0]
        coll = fl.hierarchical_ota_allreduce(x, plan1, noise1)
        coll_cpu = fl.hierarchical_ota_allreduce(
            x.cpu(), plan1, tuple(u.cpu() for u in noise1), group=gloo)
        errs["hierarchical_vs_cpu_rel"] = rel_err(coll, coll_cpu)
        errs["hierarchical_vs_input_rel"] = rel_err(coll, x)

        stamps = []
        t0 = time.perf_counter()
        h = run_rounds(*workload, cfg, device=DEVICE, shard="clients",
                       mode="loop",
                       progress=lambda *_: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # The default scan: the round and its collectives captured.
        scan_timers = PhaseTimers()
        hs = run_rounds(*workload, cfg, device=DEVICE, shard="clients",
                        timers=scan_timers)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            run_rounds(*workload, cfg, device=DEVICE, shard="clients",
                       timers=PhaseTimers())
            torch.cuda.synchronize()
        scan_profile = scan_window(prof, rounds)
        nccl = sum(c for k, c in scan_profile.pop("by_name").items()
                   if "nccl" in k.lower())
        del prof
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    scan_gap = histories_equal(hs, h)
    loss_s, acc_s = h["train_loss"].tolist(), h["test_acc"].tolist()
    loss_u, acc_u = static["train_loss"], static["test_acc"]
    unsharded_bitwise = (hs["train_loss"].tolist() == loss_u
                         and hs["test_acc"].tolist() == acc_u)
    sharded_ok = all(abs(a - b) <= 1e-6 + 1e-5 * abs(b)
                     for a, b in zip(loss_s, loss_u)) and all(
        abs(a - b) <= 1e-2 for a, b in zip(acc_s, acc_u))
    line = {"phase": "dist", "K": K, "C": cfg.num_clusters, "d": d,
            "launches": launches, "errors": errs,
            "tol": {"phase1_ota_flat_vs_cpu_rel": 1e-5,
                    "cwfl_aggregate_flat_vs_tree_abs": F32_ATOL,
                    "ota_aggregate_op_vs_cpu_rel": 1e-5,
                    "make_fl_plan_rel": 1e-5,
                    "hierarchical_vs_cpu_rel": 1e-6,
                    "sharded_loss": "rtol 1e-5, atol 1e-6",
                    "sharded_acc_abs": 1e-2},
            "plan_heads": plans[DEVICE].heads.tolist(),
            "plan_noise_std": plans[DEVICE].noise_std,
            "own_plan_clusters": own.num_clusters,
            "sharded_rounds": rounds, "sharded_wall_s": wall,
            "sharded_rounds_per_s": rounds / wall,
            "sharded_steady_rounds_per_s": (rounds - 1) / (stamps[-1]
                                                           - stamps[0]),
            "sharded_train_loss": loss_s, "unsharded_train_loss": loss_u,
            "sharded_test_acc": acc_s, "unsharded_test_acc": acc_u,
            "sharded_scan_vs_loop": scan_gap,
            "sharded_scan_bitwise_unsharded": bool(unsharded_bitwise),
            "sharded_scan_timers": scan_timers.as_dict(),
            "sharded_scan_steady_rounds_per_s": (
                (rounds - 1) / scan_timers.seconds["execute"]),
            "sharded_scan_profiled": scan_profile,
            "sharded_scan_nccl_kernels_per_round": nccl / (rounds - 1)}
    emit(line)
    if launches != {"ota_aggregate": 2, "cwfl_round": 1}:
        raise AssertionError(f"kernel launches on the dist path {launches}, "
                             f"expected 2 of ota_aggregate (phase1_ota_flat"
                             f", ota_aggregate_op) and 1 of cwfl_round")
    if not (shapes_ok and plan_ok and own.num_clusters == 3
            and np.isclose(own.beta.sum(), 1.0)
            and all(torch.isfinite(t).all() for t in (y, new, cons, coll))
            and errs["phase1_ota_flat_vs_cpu_rel"] <= 1e-5
            and errs["cwfl_aggregate_flat_vs_tree_abs"] <= F32_ATOL
            and errs["ota_aggregate_op_vs_cpu_rel"] <= 1e-5
            and errs["make_fl_plan_beta_rel"] <= 1e-5
            and errs["make_fl_plan_noise_std_rel"] <= 1e-5
            and errs["hierarchical_vs_cpu_rel"] <= 1e-6 and sharded_ok
            and scan_gap["bitwise"]):
        raise AssertionError(f"the dist phase failed a check: {line}")
    return launches["ota_aggregate"]


# The scenarios driven at full width.  Their floors come from the JAX
# package at this configuration on the CPU (scripts/jax_scenario_reference.py
# --seed S, S = 0, 3, 6, 9):
# - SCENARIO_FLOOR, the least round-5 test accuracy: the lowest that any of
#   the four scenarios reaches at round 5 over the four seeds (0.894,
#   head-failure at S = 3), rounded down; at S = 0, the seeding used here,
#   they reach 0.970-0.979;
# - STATIC_GAP, how far a scenario may trail paper-static at the same round:
#   a scenario run shares the static run's data, initial params, batches
#   and noise, and over the four seeds JAX's scenarios trail paper-static
#   by at most 0.006 at a round 4 or 5 that synced; the gap allows five
#   times that.
# A round whose mask mass is 0 (a blackout) skips the sync and keeps the
# last consensus, so its accuracy must equal the round before's; the floors
# then hold at the last round that synced.
def fl_gate(gap: dict) -> bool:
    """Two histories agree: bit for bit, or within the FL card-vs-CPU gate
    (loss 1e-4 relative, params 1e-4, accuracy 2 of the 2,048 evaluation
    samples) with equal scenario records."""
    return gap["bitwise"] or (gap["loss_rel"] <= 1e-4
                              and gap["param_abs"] <= 1e-4
                              and gap["acc_abs"] <= 2 / 2048
                              and gap["records_equal"])


def scan_beside_loop(label, loop_history, kmod, omod, rounds, want, run):
    """``run(mode="scan", timers=)``, the run whose loop-mode history is
    ``loop_history``, once under ``torch.profiler`` (the card's activity
    only): the FL kernels' launches as the profiler counts them must be
    ``want``; the wrappers, called only for the warm-up and the captures,
    fewer times (the replays launched the rest); and the history the
    loop's (`fl_gate`).  Returns the scan's steady rounds/s (rounds 2..T,
    the ``execute`` phase, profiled), both launch counts and the gap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import PhaseTimers

    timers = PhaseTimers()
    torch.cuda.synchronize()
    omod.launches = kmod.launches = kmod.launches_guard = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h = run(mode="scan", timers=timers)
        torch.cuda.synchronize()
    calls = {"cwfl_round": kmod.launches,
             "cwfl_round_guard": kmod.launches_guard,
             "ota_aggregate": omod.launches}
    every = profiled_launches(prof)
    gap = histories_equal(h, loop_history)
    out = {"steady_rounds_per_s_profiled": (rounds - 1)
           / timers.seconds["execute"],
           "trace_compile_s": timers.seconds["trace_compile"],
           "profiled_launches": every, "wrapper_calls": calls,
           "scan_vs_loop": gap}
    if every != want:
        raise AssertionError(f"{label}: the scan run launched {every}, "
                             f"expected {want} in {rounds} rounds")
    if any(n and not calls[k] < n for k, n in want.items()):
        raise AssertionError(f"{label}: the wrappers were called {calls} "
                             f"times for {every} launches: the scan did "
                             f"not replay")
    if not fl_gate(gap):
        raise AssertionError(f"{label}: the scan history is off the "
                             f"loop's: {gap}")
    return out


SCENARIOS = ("head-failure", "flaky-clients", "mobile-fading",
             "cluster-churn", "straggler-heavy")
SCENARIO_FLOOR = 0.89
STATIC_GAP = 0.03


def scenario_phase(kmod, omod, static_acc, rounds: int = 5):
    """run_federated at full width under each dynamic scenario, in loop
    mode and then in scan mode (`scan_beside_loop`; straggler-heavy's
    straggler rounds take a graph of their own): every sync of a fault
    scenario launches the guarded kernel and no other, every other
    scenario's sync the unguarded one; the test accuracy holds the floors
    above against ``static_acc``, the slice phase's per-round accuracy.
    Returns the guarded launches of the fault scenarios' loop runs."""
    from repro_torch.core import TopologyConfig
    from repro_torch.sim import get_scenario
    from repro_torch.training import FLConfig, run_federated

    workload = full_width_workload()
    topo_cfg = TopologyConfig(num_clients=int(workload[4].shape[0]))
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    guarded = 0
    for name in SCENARIOS:
        fault = not get_scenario(name).faults.is_trivial
        stamps = []
        kmod.launches = kmod.launches_guard = 0
        t0 = time.perf_counter()
        h = run_federated(*workload, cfg,
                          progress=lambda *_: stamps.append(
                              time.perf_counter()),
                          scenario=name, topo_cfg=topo_cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, launches_guard = kmod.launches, kmod.launches_guard
        scan = scan_beside_loop(
            name, h, kmod, omod, rounds,
            {"cwfl_round": 0 if fault else rounds,
             "cwfl_round_guard": rounds if fault else 0, "ota_aggregate": 0},
            lambda **kw: run_federated(*workload, cfg, scenario=name,
                                       topo_cfg=topo_cfg, device=DEVICE,
                                       **kw))
        rec = h["scenario"]
        for r in range(rounds):
            emit({"phase": "scenario", "scenario": name, "round": r + 1,
                  "train_loss": h["train_loss"][r],
                  "test_acc": h["test_acc"][r], "alive": rec["alive"][r],
                  "heads": rec["heads"][r],
                  "mask_mass": rec["mask_mass"][r],
                  "quarantined": rec["quarantined"][r]})
        line = {"phase": "scenario", "scenario": name, "rounds": rounds,
                "wall_s": wall, "rounds_per_s": rounds / wall,
                "steady_rounds_per_s": (rounds - 1) / (stamps[-1]
                                                       - stamps[0]),
                "cwfl_round_launches": launches,
                "cwfl_round_guard_launches": launches_guard,
                "train_loss": h["train_loss"], "test_acc": h["test_acc"],
                "scan": scan}
        emit(line)
        want = (0, rounds) if fault else (rounds, 0)
        if (launches, launches_guard) != want:
            raise AssertionError(f"{name}: (unguarded, guarded) launches "
                                 f"{(launches, launches_guard)}, expected "
                                 f"{want} in {rounds} rounds")
        if not all(math.isfinite(x) for x in h["train_loss"]):
            raise AssertionError(f"{name}: non-finite train loss {line}")
        acc, mass = h["test_acc"], rec["mask_mass"]
        synced = [r for r in range(rounds) if mass[r] > 0]
        if not synced:
            raise AssertionError(f"{name}: no round synced: {mass}")
        last = synced[-1]
        if any(acc[r] != acc[last] for r in range(last + 1, rounds)):
            raise AssertionError(f"{name}: a blackout round after round "
                                 f"{last + 1} moved the consensus: {acc}")
        if last == rounds - 1 and not acc[last] >= SCENARIO_FLOOR:
            raise AssertionError(f"{name}: round-{rounds} test accuracy "
                                 f"{acc[last]} < {SCENARIO_FLOOR}")
        if not acc[last] >= static_acc[last] - STATIC_GAP:
            raise AssertionError(
                f"{name}: round-{last + 1} test accuracy {acc[last]} trails "
                f"paper-static's {static_acc[last]} by more than "
                f"{STATIC_GAP}")
        guarded += launches_guard
    return guarded


# The other strategies at full width (static): ota_aggregate launches a
# round (FedAvg and COTAF one row of weights, decentralized K=50 rows, one
# launch each) and cwfl_round launches a round, and the least round-5 test
# accuracy.  The floors come from the JAX package at this configuration on
# the CPU (scripts/jax_strategy_reference.py --seed S, S = 0, 3, 6, 9): the
# lowest round-5 accuracy of the strategy over the four seeds, less 0.02,
# rounded down to 0.01.
STRATEGY_RUNS = (
    # strategy, ota_aggregate launches a round, cwfl_round's, floor
    ("fedavg", 1, 0, 0.88),          # JAX: 0.910-0.989
    ("cotaf", 1, 0, 0.89),           # 0.919-0.990
    ("decentralized", 1, 0, 0.88),   # 0.910-0.989
    ("cwfl_prox", 0, 1, 0.87),       # 0.900-0.992
    ("cotaf_prox", 1, 0, 0.89),      # 0.919-0.989
)


def strategies_phase(omod, kmod, rounds: int = 5):
    """run_federated at full width with each strategy of STRATEGY_RUNS, in
    loop mode and then in scan mode (`scan_beside_loop`): its syncs'
    kernel launches, counted from 0 for each run, and its round-5
    accuracy against its floor.  Returns the ``ota_aggregate`` launches
    of the one-row loop runs (FedAvg, COTAF, COTAF-Prox) and of the
    decentralized one."""
    from repro_torch.training import FLConfig, run_federated

    workload = full_width_workload()
    one_row = many_rows = 0
    for name, ota_a_round, cwfl_a_round, floor in STRATEGY_RUNS:
        cfg = FLConfig(strategy=name, rounds=rounds, num_clusters=3,
                       snr_db=40.0, seed=0)
        stamps = []
        torch.cuda.synchronize()
        omod.launches = kmod.launches = kmod.launches_guard = 0
        t0 = time.perf_counter()
        h = run_federated(*workload, cfg,
                          progress=lambda *_: stamps.append(
                              time.perf_counter()), device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ota_aggregate": omod.launches,
                    "cwfl_round": kmod.launches,
                    "cwfl_round_guard": kmod.launches_guard}
        want = {"ota_aggregate": ota_a_round * rounds,
                "cwfl_round": cwfl_a_round * rounds, "cwfl_round_guard": 0}
        scan = scan_beside_loop(
            name, h, kmod, omod, rounds, want,
            lambda **kw: run_federated(*workload, cfg, device=DEVICE, **kw))
        line = {"phase": "strategies", "strategy": name, "rounds": rounds,
                "wall_s": wall, "rounds_per_s": rounds / wall,
                "steady_rounds_per_s": (rounds - 1) / (stamps[-1]
                                                       - stamps[0]),
                "launches": launches, "acc_floor": floor,
                "train_loss": h["train_loss"], "test_acc": h["test_acc"],
                "scan": scan}
        emit(line)
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, "
                                 f"expected {want} in {rounds} rounds")
        if not all(math.isfinite(x) for x in h["train_loss"]):
            raise AssertionError(f"{name}: non-finite train loss {line}")
        if not h["train_loss"][-1] < h["train_loss"][0]:
            raise AssertionError(f"{name}: train loss did not fall {line}")
        if not h["test_acc"][-1] >= floor:
            raise AssertionError(f"{name}: round-{rounds} test accuracy "
                                 f"{h['test_acc'][-1]} < {floor}")
        if name == "decentralized":
            many_rows += launches["ota_aggregate"]
        else:
            one_row += launches["ota_aggregate"]
    return one_row, many_rows


# The quickstart's final accuracies on the card's own draws must reach
# these floors.  At 12 rounds of 5 steps at lr 1e-3 the accuracy still
# climbs steeply, so it spreads widely with the draws: over S = 0..15 the
# JAX package reaches 0.678-0.900 (cwfl) and 0.736-0.922 (fedavg) at round
# 12 (scripts/jax_strategy_reference.py --quickstart --seed S), the port on
# the CPU 0.589-0.973 and 0.610-0.981 (scripts/quickstart_seeds.py).  The
# floor is the lowest of the 32 runs less 0.05, rounded down to 0.01: it
# catches a run that does not learn; the run against the CPU on the same
# inputs below is the check of the numbers.
QUICKSTART_FLOOR = {"cwfl": 0.53, "fedavg": 0.56}


def quickstart_phase(omod, kmod):
    """``examples/quickstart_torch.main()`` on the card end to end, its
    printing included: 12 rounds of ``cwfl`` (one ``cwfl_round`` launch a
    round) and 12 of ``fedavg`` (one ``ota_aggregate`` launch a round),
    each final accuracy against its floor.  Then its ``run`` on inputs and
    draws made on the CPU, on the card against the CPU, under the
    reference phase's gates."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.core import TopologyConfig, make_topology
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_iid)
    from repro_torch.sim import TorchDraws
    from repro_torch.utils import tree_leaves

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    torch.cuda.synchronize()
    omod.launches = kmod.launches = kmod.launches_guard = 0
    t0 = time.perf_counter()
    out = quickstart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ota_aggregate": omod.launches, "cwfl_round": kmod.launches,
                "cwfl_round_guard": kmod.launches_guard}
    hist = out["histories"]

    # The same run() on the card and on the CPU, from the CPU's inputs.
    K = quickstart.K
    topo = make_topology(0, TopologyConfig(num_clients=K, num_hotspots=3),
                         device="cpu")
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        1, SyntheticImageConfig.mnist_like(6000, 1500), device="cpu")
    xs, ys = partition_iid(2, xtr, ytr, K)
    runs = {}
    for dev in (DEVICE, "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            runs[dev] = quickstart.run(
                topo, (xs, ys, xte, yte), first=0, device=dev,
                draws=lambda: TorchDraws(0, "cpu"))["histories"]
    errs = {}
    for name in hist:
        gpu, cpu = runs[DEVICE][name], runs["cpu"][name]
        errs[name] = {
            "loss_rel": max(abs(a / b - 1) for a, b in zip(
                gpu["train_loss"], cpu["train_loss"])),
            "acc_abs": max(abs(a - b) for a, b in zip(gpu["test_acc"],
                                                      cpu["test_acc"])),
            "param_abs": max(
                float((a.cpu() - b).abs().max()) for a, b in zip(
                    tree_leaves(gpu["final_params"]),
                    tree_leaves(cpu["final_params"])))}
    line = {"phase": "quickstart", "wall_s": wall, "launches": launches,
            "heads": out["plan"].heads.tolist(),
            "channel_uses": out["channel_uses"],
            "floors": QUICKSTART_FLOOR,
            **{f"{name}_{key}": hist[name][key] for name in hist
               for key in ("train_loss", "test_acc")},
            "cuda_vs_cpu": errs,
            "tol": {"loss_rel": 1e-4, "acc_abs": 2 / 1024,
                    "param_abs": 1e-4}}
    emit(line)
    rounds = len(hist["cwfl"]["train_loss"])
    want = {"ota_aggregate": rounds, "cwfl_round": rounds,
            "cwfl_round_guard": 0}
    if rounds != 12 or launches != want:
        raise AssertionError(f"quickstart: kernel launches {launches}, "
                             f"expected {want} over 12 rounds of each run")
    for name, h in hist.items():
        if not (all(math.isfinite(x) for x in h["train_loss"])
                and h["train_loss"][-1] < h["train_loss"][0]
                and h["final_acc"] >= QUICKSTART_FLOOR[name]):
            raise AssertionError(f"quickstart: the {name} run failed its "
                                 f"checks: {line}")
        e = errs[name]
        if not (e["loss_rel"] <= 1e-4 and e["acc_abs"] <= 2 / 1024
                and e["param_abs"] <= 1e-4):
            raise AssertionError(f"quickstart: the {name} run on the card "
                                 f"disagrees with the CPU: {line}")


def cnn_reference_phase(strategy: str, mu_prox: float = 0.0,
                        rounds: int = 2) -> None:
    """The CIFAR CNN at 8×8×3 on the card against the same run on the
    CPU, with the same draws (made on the CPU), data and topology: K=4,
    C=3, a non-IID split (2 of 40 shards a client, 2 steps of 16 a
    round), under the reference phase's gates.  The card's run goes
    through the grouped convolutions of the stacked path and the round
    kernels."""
    from repro_torch.core import TopologyConfig, make_topology
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_noniid)
    from repro_torch.models import make_cifar_cnn, nll_loss
    from repro_torch.sim import TorchDraws
    from repro_torch.training import FLConfig, run_federated
    from repro_torch.utils import tree_leaves

    K, hw = 4, (8, 8, 3)
    topo = make_topology(7, TopologyConfig(num_clients=K), device="cpu")
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        0, SyntheticImageConfig("cifar-like", *hw, 10, 640, 256),
        device="cpu")
    xs, ys = partition_noniid(1, xtr, ytr, K, 2, num_shards=40)
    init, apply = make_cifar_cnn(hw)
    loss = lambda p, x, y: nll_loss(apply(p, x), y)   # noqa: E731
    cfg = FLConfig(strategy=strategy, rounds=rounds, batch_size=16,
                   mu_prox=mu_prox, eval_samples=256, lr=0.01)
    runs = {dev: run_federated(
        init, apply, loss, topo.to(dev), xs.to(dev), ys.to(dev), xte.to(dev),
        yte.to(dev), cfg, draws=TorchDraws(0, "cpu"), device=dev)
        for dev in (DEVICE, "cpu")}
    gpu, cpu = runs[DEVICE], runs["cpu"]
    loss_rel = max(abs(a / b - 1) for a, b in zip(gpu["train_loss"],
                                                   cpu["train_loss"]))
    param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(gpu["final_params"]), tree_leaves(cpu["final_params"])))
    acc_err = max(abs(a - b) for a, b in zip(gpu["test_acc"],
                                            cpu["test_acc"]))
    line = {"phase": "reference", "run": f"cnn-{strategy}",
            "strategy": strategy, "mu_prox": mu_prox, "input_hw": hw,
            "K": K, "noniid_shards": 40, "rounds": rounds,
            "train_loss_cuda": gpu["train_loss"],
            "train_loss_cpu": cpu["train_loss"], "loss_rel_err": loss_rel,
            "tol_loss_rel": 1e-4, "test_acc_cuda": gpu["test_acc"],
            "test_acc_cpu": cpu["test_acc"], "acc_abs_err": acc_err,
            "tol_acc_abs": 2 / 256, "param_abs_err": param_err,
            "tol_param_abs": 1e-4}
    emit(line)
    if not all(math.isfinite(x) for x in gpu["train_loss"]):
        raise AssertionError(f"non-finite train loss on the card: {line}")
    if not (loss_rel <= 1e-4 and acc_err <= 2 / 256 and param_err <= 1e-4):
        raise AssertionError(f"the CNN {strategy} run on the card disagrees "
                             f"with the CPU: {line}")


# The paper phase: Table I's CIFAR column and MNIST CWFL-4 on the paper's
# protocol at full width (`repro_torch.paper.common.run_setting` at
# BenchScale.full(): CIFAR K=27, 50,000/10,000 cifar-like, 7 of 189 shards
# a client, batch 32; MNIST K=50, 60,000/10,000, 4 of 200 shards, batch
# 64; lr 1e-3, 40 dB, eval on 4,096), cut to PAPER_ROUNDS of the paper's
# 70.  Per row: the summary row its kernel's launches count toward, and
# the least round-3 test accuracy.  On a non-IID split that accuracy
# swings with the draws.  The JAX package (scripts/jax_paper_reference.py
# --seed S): CWFL-3 0.931-1.0 and COTAF 0.989-1.0 at S = 0..5, their prox
# twins 0.994-1.0 and 0.989-1.0 at S = 0..2, MNIST CWFL-4 0.504-0.792 at
# S = 0..5.  The port on the card (scripts/paper_seeds.py, S = 0..5):
# COTAF 0.936-1.0, CWFL-3 0.918-1.0, MNIST CWFL-4 0.561-0.715, each prox
# row within 0.001 of its twin.  A floor is the lowest of the row's and
# its twin's runs in both packages less 0.03, rounded down to 0.01.
PAPER_ROUNDS = 3
PAPER_RUNS = (
    # label, dataset, strategy, clusters, µ_p, kernels-summary row, floor
    ("cifar/COTAF", "cifar", "cotaf", 3, 0.0, "ota_aggregate[cifar C=1]",
     0.90),
    ("cifar/COTAF-Prox", "cifar", "cotaf", 3, 0.1,
     "ota_aggregate[cifar C=1]", 0.90),
    ("cifar/CWFL-3", "cifar", "cwfl", 3, 0.0, "cwfl_round[cifar]", 0.88),
    ("cifar/CWFL-3-Prox", "cifar", "cwfl", 3, 0.1, "cwfl_round[cifar]",
     0.88),
    ("mnist/CWFL-4", "mnist", "cwfl", 4, 0.0, "cwfl_round[C=4]", 0.47),
)


def paper_phase(omod, kmod) -> dict:
    """Each row of PAPER_RUNS through ``run_setting`` on the card: steady
    rounds/s (rounds 2-3), the kernels' launches counted from 0 for the
    run (one ``cwfl_round`` a CWFL round, one ``ota_aggregate`` a COTAF
    round, none of the other), peak device memory, and the round-3
    accuracy against its floor.  Returns the launches by kernels-summary
    row."""
    import dataclasses

    from repro_torch.paper.common import BenchScale, run_setting
    from repro_torch.utils import tree_size

    scale = dataclasses.replace(BenchScale.full(), rounds=PAPER_ROUNDS)
    launches_by_row = {}
    for label, ds, strategy, C, mu, row, floor in PAPER_RUNS:
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        omod.launches = kmod.launches = kmod.launches_guard = 0
        t0 = time.perf_counter()
        h = run_setting(ds, False, strategy, scale, num_clusters=C,
                        mu_prox=mu, device=DEVICE,
                        progress=lambda *_: stamps.append(
                            time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ota_aggregate": omod.launches,
                    "cwfl_round": kmod.launches,
                    "cwfl_round_guard": kmod.launches_guard}
        d = tree_size(h["final_params"])
        line = {"phase": "paper", "row": label, "strategy": strategy,
                "clusters": C, "mu_prox": mu, "d": d,
                "rounds": PAPER_ROUNDS, "wall_s": wall,
                "seconds_per_round": h["seconds_per_round"],
                "steady_rounds_per_s": (PAPER_ROUNDS - 1) / (stamps[-1]
                                                             - stamps[0]),
                "launches": launches,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "train_loss": h["train_loss"], "test_acc": h["test_acc"],
                "acc_floor": floor}
        emit(line)
        kernel = "cwfl_round" if strategy == "cwfl" else "ota_aggregate"
        want = {"ota_aggregate": 0, "cwfl_round": 0, "cwfl_round_guard": 0,
                kernel: PAPER_ROUNDS}
        if launches != want:
            raise AssertionError(f"{label}: kernel launches {launches}, "
                                 f"expected {want} in {PAPER_ROUNDS} rounds")
        if d != (698250 if ds == "cifar" else 184214):
            raise AssertionError(f"{label}: flat dimension {d}")
        if not all(math.isfinite(x) for x in h["train_loss"]):
            raise AssertionError(f"{label}: non-finite train loss {line}")
        if not h["test_acc"][-1] >= floor:
            raise AssertionError(f"{label}: round-{PAPER_ROUNDS} test "
                                 f"accuracy {h['test_acc'][-1]} < {floor}")
        launches_by_row[row] = launches_by_row.get(row, 0) + \
            launches[kernel]
    return launches_by_row


def cifar_profile_phase(rounds: int = 2) -> None:
    """Where a CIFAR round's time goes: ``torch.profiler`` over round 2 of
    CWFL-3 at full width (``run_setting`` on the paper's CIFAR protocol),
    the setup and the first round outside the window; device busy (the
    union of the kernels' intervals) and idle share, launches, and device
    time by kind of kernel."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.paper.common import BenchScale, run_setting

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def progress(r, loss, acc):
        torch.cuda.synchronize()
        if r == rounds - 1:
            prof.start()
            window["t0"] = time.perf_counter()
        elif r == rounds:
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    scale = dataclasses.replace(BenchScale.full(), rounds=rounds)
    run_setting("cifar", False, "cwfl", scale, device=DEVICE,
                progress=progress)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    # Kernels may overlap (cuDNN runs a grouped convolution's groups on
    # streams of its own): the device is busy over the union of their
    # intervals, which their summed times overstate.
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    union_us, end = 0.0, -math.inf
    for a, b in spans:
        union_us += max(0.0, b - max(a, end))
        end = max(end, b)
    # By cuDNN's, CUTLASS's and ATen's kernel names, first match wins.
    kinds = {"conv_forward": ("fprop", "convolve", "grouped_direct"),
             "conv_backward_data": ("dgrad",),
             "conv_backward_weights": ("wgrad", "Wgrad"),
             "conv_layout": ("Transpose", "ToNhwc", "ToNchw", "SliceC",
                             "scaleTensor"),
             "round_kernel": ("cwfl_round_kernel",),
             "max_pool": ("max_pool", "MaxPool"),
             "gemm": ("gemm", "nvjet", "cutlass", "xmma")}
    by_kind = dict.fromkeys(kinds, 0.0)
    by_kind["other"] = 0.0
    for name, ms, _ in rows:
        kind = next((k for k, words in kinds.items()
                     if any(w in name for w in words)), "other")
        by_kind[kind] += ms
    wall_ms = window["wall_ms"]
    busy_ms = union_us / 1e3
    emit({"phase": "profile", "run": "cifar/CWFL-3", "rounds_in_window": 1,
          "wall_ms_per_round": wall_ms, "device_busy_ms_per_round": busy_ms,
          "device_kernel_ms_sum_per_round": sum(r[1] for r in rows),
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_launches_per_round": sum(r[2] for r in rows),
          "device_ms_by_kind": by_kind,
          "top": [[name[:90], ms, cnt] for name, ms, cnt in rows[:15]]})


def profile_phase(scenario: str = "paper-static", rounds: int = 6):
    """Where a round's time goes on the card: ``torch.profiler`` over
    rounds 2..``rounds`` of ``run_federated`` at full width under
    ``scenario``, with the setup and the first round outside its window —
    device time by kernel, launches per round, and the device's idle share
    of the window's wall time (under the profiler, which slows the host,
    and with the host reading each round's loss and accuracy, as the slice
    phase does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TopologyConfig
    from repro_torch.training import FLConfig, run_federated

    workload = full_width_workload()
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def progress(r, loss, acc):
        torch.cuda.synchronize()
        if r == 1:
            prof.start()
            window["t0"] = time.perf_counter()
        elif r == rounds:
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    run_federated(*workload, cfg, progress=progress, scenario=scenario,
                  topo_cfg=TopologyConfig(num_clients=50), device=DEVICE)
    n = rounds - 1
    # Device-side events only: a CPU op's row repeats the time of the
    # kernels it launched.
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    wall_ms = window["wall_ms"]
    busy_ms = sum(r[1] for r in rows)
    round_ms = sum(r[1] for r in rows if "cwfl_round_kernel" in r[0])
    emit({"phase": "profile", "scenario": scenario, "rounds_in_window": n,
          "wall_ms_per_round": wall_ms / n,
          "device_busy_ms_per_round": busy_ms / n,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_launches_per_round": sum(r[2] for r in rows) / n,
          "cwfl_round_device_ms_per_round": round_ms / n,
          "top": [[name[:90], ms / n, cnt / n]
                  for name, ms, cnt in rows[:12]]})


# flash_attention at the shapes Gemma-2 9B's prefill gives it (B=2 requests
# of 4,608 tokens, 16 heads on 8 KV heads, head dim 256; local layers with
# a 4,096-token window, global ones without; softcap 50), their bf16 and
# cap-0 variants, a ragged GQA shape in each dtype, and a small shape for
# every head dim and dtype the kernels are built for (f32: the 3×TF32
# kernel, bf16: the bf16 one); then the mixers phase's shapes: Qwen3-MoE's
# prefill (G = 16), Kimi K2's head dim 112 (q, k and v zero-padded by
# `kernels.ops.pad_head_dim`, as `flash_attention_op` pads them, the
# output sliced back), Jamba's bf16 and InternVL2's f32 prefills,
# whisper's bidirectional encoder and its cross-attention (64 queries on
# 1,500 frames in the prefill, one in each decode step).  q is scaled by
# 4 so that the scores reach past ±15 and the softcap bends them.  A
# row's optional last entry: ``causal`` (default True), ``skv`` (keys,
# default S).
FA_SHAPES = (
    # label, B, H, KV, S, D, dtype, window, cap[, options]
    ("gemma2_global", 2, 16, 8, 4608, 256, torch.float32, 0, 50.0),
    ("gemma2_local", 2, 16, 8, 4608, 256, torch.float32, 4096, 50.0),
    ("gemma2_global_bf16", 2, 16, 8, 4608, 256, torch.bfloat16, 0, 50.0),
    ("gemma2_local_bf16", 2, 16, 8, 4608, 256, torch.bfloat16, 4096, 50.0),
    ("gemma2_global_cap0", 2, 16, 8, 4608, 256, torch.float32, 0, 0.0),
    ("gemma2_local_cap0", 2, 16, 8, 4608, 256, torch.float32, 4096, 0.0),
    ("gemma2_global_bf16_cap0", 2, 16, 8, 4608, 256, torch.bfloat16, 0, 0.0),
    ("ragged_gqa", 1, 16, 2, 1000, 128, torch.float32, 0, 0.0),
    ("ragged_gqa_bf16", 1, 16, 2, 1000, 128, torch.bfloat16, 0, 0.0),
) + tuple((f"small_d{D}_{str(dt)[6:]}", 2, 6, 2, 130, D, dt, 40, 50.0)
          for D in (32, 64, 128, 256)
          for dt in (torch.float32, torch.bfloat16)) + (
    ("qwen3_moe_prefill_bf16", 2, 64, 4, 2048, 128, torch.bfloat16, 0, 0.0),
    ("kimi_k2_d112_bf16", 1, 64, 8, 2048, 112, torch.bfloat16, 0, 0.0),
    ("jamba_prefill_bf16", 2, 32, 8, 2048, 128, torch.bfloat16, 0, 0.0),
    ("internvl2_prefill_f32", 2, 16, 8, 2048, 128, torch.float32, 0, 0.0),
    ("whisper_encoder", 2, 6, 6, 1500, 64, torch.float32, 0, 0.0,
     {"causal": False}),
    ("whisper_cross", 2, 6, 6, 64, 64, torch.float32, 0, 0.0,
     {"causal": False, "skv": 1500}),
    ("whisper_cross_decode", 2, 6, 6, 1, 64, torch.float32, 0, 0.0,
     {"causal": False, "skv": 1500}),
)
# Tolerances against the plain version (f32 sums in another order, and
# bf16 outputs); the full-width shapes sum 4,608 terms a row.
FA_TOL = {"full_f32": 1e-4, "small_f32": 2e-5, "bf16": 5e-2}


def flex_yardstick(q, k, v, window: int, cap: float):
    """``flex_attention`` set up to compute the kernel's function on these
    inputs: its default D^-0.5 scale, the softcap as its ``score_mod``,
    the causal/window band as its block mask, GQA.  Compiled, as it is
    meant to be used; eager if the compiler fails here.  Returns the call
    and its name."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def band(b, h, qi, ki):
        keep = ki <= qi
        return keep & (ki > qi - window) if window > 0 else keep

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    S = q.shape[2]
    kw = {"block_mask": create_block_mask(band, None, None, S, S,
                                          device=DEVICE),
          "score_mod": softcap, "enable_gqa": True}
    import torch._inductor.config as inductor_config
    inductor_config.compile_threads = 1   # no pool of workers left behind
    compiled = torch.compile(flex_attention, dynamic=False)
    try:
        compiled(q, k, v, **kw)
        torch.cuda.synchronize()
        return (lambda: compiled(q, k, v, **kw)), "flex_attention (compiled)"
    except Exception as exc:   # the yardstick only; the port never calls it
        emit({"phase": "kernel", "note": f"flex_attention did not compile, "
                                         f"timed eager: {exc!r}"[:500]})
        return (lambda: flex_attention(q, k, v, **kw)), \
            "flex_attention (eager)"


def flash_kernel_phase(fa, ref_fn, shapes=FA_SHAPES):
    """flash_attention against its plain version at FA_SHAPES, its output
    poisoned with NaN before each launch; returns the rows of the kernels
    summary for the f32 kernel and the bf16 kernel, each at the main
    path's shape in its dtype (the global layer, cap 50).  An f32 line
    carries two operation bounds: on the CUDA cores at the f32 rate
    (``bound_ms_operations``), and on the tensor cores as three TF32
    passes (``bound_ms_tf32x3``), the least time for this work at f32
    accuracy, which is the f32 row's ``bound_ms``."""
    import torch.nn.functional as F

    from repro_torch.kernels.ops import pad_head_dim
    from repro_torch.launch.roofline import unmasked_pairs

    bw, peak_f32, peak_bf16, peak_tf32 = card_peaks(
        torch.cuda.get_device_name(0))
    rows = {}
    for label, B, H, KV, S, D, dtype, window, cap, *opts in shapes:
        opts = opts[0] if opts else {}
        causal, Skv = opts.get("causal", True), opts.get("skv", S)
        g = torch.Generator(DEVICE).manual_seed(S + D + window)
        q = (4 * torch.randn(B, H, S, D, generator=g, device=DEVICE)).to(
            dtype)
        k = torch.randn(B, KV, Skv, D, generator=g, device=DEVICE).to(dtype)
        v = torch.randn(B, KV, Skv, D, generator=g, device=DEVICE).to(dtype)
        mode = {"causal": causal, "window": window, "cap": cap}
        # The kernel's inputs: zero-padded to the head dim it runs D at,
        # with the real D's scale, as the model's op hands them over.
        padded = [pad_head_dim(x) for x in (q, k, v)]

        def kernel():
            return fa.flash_attention(*padded, scale=D ** -0.5,
                                      **mode)[..., :D]

        out = poisoned_launch(kernel, padded[0].shape, dtype)
        ref = ref_fn(q, k, v, **mode)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = (FA_TOL["bf16"] if dtype == torch.bfloat16 else
               FA_TOL["full_f32"] if S >= 4096 else FA_TOL["small_f32"])
        line = {"phase": "kernel", "kernel": "flash_attention",
                "shape": label, "B": B, "H": H, "KV": KV, "S": S, "D": D,
                "dtype": str(dtype), "window": window, "cap": cap,
                "causal": causal, "Skv": Skv, "kernel_D": padded[0].shape[-1],
                "max_abs_err": err, "tol": tol,
                "finite": bool(torch.isfinite(out.float()).all())}
        if not label.startswith("small"):
            pairs = B * H * unmasked_pairs(S, window, causal, Skv)
            flops = 4 * D * pairs
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32
            bound_bytes, bound_ops = nbytes / bw * 1e3, flops / peak * 1e3
            reps = 10 if S >= 4096 else 30
            ms = time_cold(kernel, reps)
            plain_ms = time_cold(lambda: ref_fn(q, k, v, **mode), reps)
            line.update(ms=ms, plain_ms=plain_ms, flops=flops,
                        bytes=nbytes, bound_ms_bytes=bound_bytes,
                        bound_ms_operations=bound_ops,
                        achieved_flops_per_s=flops / (ms * 1e-3))
            if dtype == torch.float32:
                line["bound_ms_tf32x3"] = 3 * flops / peak_tf32 * 1e3
            # The library yardstick, never on the port's path: one PyTorch
            # call on the same inputs, held against the plain version too.
            if cap == 0.0:
                if not causal:
                    sdpa_kw = {}
                elif window > 0:
                    qp = torch.arange(S, device=DEVICE)[:, None]
                    kp = torch.arange(S, device=DEVICE)[None, :]
                    sdpa_kw = {"attn_mask": (kp <= qp) & (kp > qp - window)}
                else:
                    sdpa_kw = {"is_causal": True}
                lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                    q, k, v, enable_gqa=True, **sdpa_kw)
                line["library"] = "scaled_dot_product_attention"
            else:
                lib, line["library"] = flex_yardstick(q, k, v, window, cap)
            line["library_max_abs_err"] = float(
                (lib().float() - ref.float()).abs().max())
            line["library_ms"] = time_cold(lib, reps)
            rows[label] = line
        del ref
        emit(line)
        if not (err <= tol and line["finite"]):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {label}: {line}")
        if line.get("library_max_abs_err", 0.0) > tol:
            raise AssertionError(f"the library yardstick computes another "
                                 f"function at {label}: {line}")
    out = []
    for name, source, suffix in (
            ("flash_attention", "flash_attention.cu", ""),
            ("flash_attention_bf16", "flash_attention_sm90.cu", "_bf16")):
        if f"gemma2_global{suffix}" not in rows:
            continue      # a subset of the shapes (scripts/mixers_phase.py)
        main = rows[f"gemma2_global{suffix}"]
        cap0 = rows[f"gemma2_global{suffix}_cap0"]
        ops = main.get("bound_ms_tf32x3", main["bound_ms_operations"])
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:28",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": max(main["bound_ms_bytes"], ops),
            "bound_by": ("bytes" if main["bound_ms_bytes"] >= ops
                         else "operations"),
            # flex_attention with the softcap; SDPA (no softcap) on the
            # same shape at cap 0 beside it, with the kernel's time there.
            "library_ms": main["library_ms"], "library": main["library"],
            "library_ms_cap0": cap0["library_ms"], "ms_cap0": cap0["ms"]}
        if "bound_ms_tf32x3" in main:
            row["bound_basis"] = "3xTF32 on the tensor cores (f32 accuracy)"
            row["bound_ms_f32_cuda_cores"] = main["bound_ms_operations"]
        out.append(row)
    return out


def greedy_card_against_cpu(fa, cfg, new_tokens: int = 8):
    """Greedy decoding of ``new_tokens`` after a 20-token prompt (2
    requests) with the same weights and batch on the CPU and on the card:
    ``(tokens on the card, on the CPU, the last logits' largest
    difference, each flash kernel's launches on the card)``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch
    from repro_torch.training.serve import greedy_decode
    from repro_torch.utils import tree_map

    params = tfm.init_params(0, cfg, device="cpu")
    batch = make_batch(1, cfg, 20, 2, kind="prefill", device="cpu")
    cpu_tokens, cpu_logits = greedy_decode(params, batch, cfg, new_tokens)
    fa.launches = fa.launches_bf16 = 0
    tokens, logits = greedy_decode(tree_map(lambda a: a.to(DEVICE), params),
                                   tree_map(lambda a: a.to(DEVICE), batch),
                                   cfg, new_tokens)
    torch.cuda.synchronize()
    return (tokens.cpu(), cpu_tokens,
            float((logits.cpu() - cpu_logits).abs().max()),
            {"f32": fa.launches, "bf16": fa.launches_bf16})


def lm_reference_phase(fa):
    """Greedy decoding of the reduced Gemma-2 on the card against the CPU,
    with the same weights and prompt: the same tokens, the last logits
    within 1e-4, and one kernel launch per layer on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import LayerSpec

    # Gemma-2 9B reduced (d_model 128, 4 layers, head dim 32), its local
    # window cut to 8 so that it bites at a 20-token prompt.
    cfg = get_config("gemma2-9b", reduced=True).replace(
        pattern=(LayerSpec("attn", 8, "dense"), LayerSpec("attn", 0, "dense")))
    tokens, cpu_tokens, err, launches = greedy_card_against_cpu(fa, cfg)
    launches = launches["f32"]
    line = {"phase": "reference", "run": "gemma2-reduced-greedy",
            "tokens_cuda": tokens.tolist(), "tokens_cpu": cpu_tokens.tolist(),
            "logits_abs_err": err, "tol_logits_abs": 1e-4,
            "flash_attention_launches": launches,
            "layers": cfg.num_layers}
    emit(line)
    if not (torch.equal(tokens, cpu_tokens) and err <= 1e-4
            and launches == cfg.num_layers):
        raise AssertionError(f"the reduced Gemma-2 on the card disagrees "
                             f"with the CPU: {line}")


# The serve phase: Gemma-2 9B as configured (f32), B requests of PROMPT
# tokens, NEW greedy tokens.  The prompt is longer than the local layers'
# 4,096-token window, so they mask and decode through the ring buffer.
SERVE_B, SERVE_PROMPT, SERVE_NEW = 2, 4608, 16
SERVE_TOL = 5e-3    # decode against forward (JAX's own consistency bound)


def timed_greedy_decode(fa, params, batch, cfg) -> dict:
    """``greedy_decode`` of SERVE_NEW tokens with both kernels' counts set
    to 0 just before: the tokens and last logits, prefill and decode
    seconds (the prefill's end read by wrapping ``transformer.prefill``,
    synchronised there), peak memory, and each kernel's launches in the
    prefill and in all (``f32``, ``bf16``)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.training.serve import greedy_decode

    prefill, marks = tfm.prefill, {}

    def timed_prefill(*args, **kwargs):
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        marks["prefill_end"] = time.perf_counter()
        marks["prefill_launches"] = (fa.launches, fa.launches_bf16)
        return out

    torch.cuda.reset_peak_memory_stats()
    tfm.prefill = timed_prefill
    fa.launches = fa.launches_bf16 = 0
    try:
        t0 = time.perf_counter()
        tokens, logits = greedy_decode(params, batch, cfg, SERVE_NEW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        tfm.prefill = prefill
    return {"tokens": tokens, "logits": logits,
            "prefill_s": marks["prefill_end"] - t0,
            "decode_s": t1 - marks["prefill_end"],
            "peak": torch.cuda.max_memory_allocated(),
            "prefill_launches": marks["prefill_launches"],
            "launches": (fa.launches, fa.launches_bf16)}


def serve_phase(fa):
    """``greedy_decode`` at full width in f32; returns the f32 kernel's
    launches over the run, the params, batch and config, and the gate the
    bf16 serve is held to: ``forward``'s last-position logits over the
    prompt and the decoded tokens, and those tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch
    from repro_torch.utils import tree_leaves

    cfg = get_config("gemma2-9b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = tfm.init_params(0, cfg, device=DEVICE)
    batch = make_batch(1, cfg, SERVE_PROMPT, SERVE_B, kind="prefill",
                       device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size()
                      for p in tree_leaves(params))

    run = timed_greedy_decode(fa, params, batch, cfg)
    tokens, logits = run["tokens"], run["logits"]
    prefill_s, decode_s = run["prefill_s"], run["decode_s"]
    launches, launches_bf16 = run["launches"]
    prefill_launches = run["prefill_launches"][0]

    # The gate: the decoded path's last logits against forward over the
    # prompt and the decoded tokens (the kernel's prefill path).
    full = {"tokens": torch.cat([batch["tokens"], tokens], dim=1)}
    want = tfm.forward(params, full, cfg)[0][:, -1].clone()
    err = float((want - logits[:, 0]).abs().max())
    line = {"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "params": tfm.count_params(cfg),
            "param_bytes": param_bytes, "batch": SERVE_B,
            "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
            "init_s": init_s, "prefill_s": prefill_s,
            "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / prefill_s,
            "decode_s": decode_s, "decode_step_ms": decode_s / SERVE_NEW * 1e3,
            "decode_tokens_per_s": SERVE_B * SERVE_NEW / decode_s,
            "flash_attention_launches_prefill": prefill_launches,
            "flash_attention_launches_decode": launches - prefill_launches,
            "peak_mem_bytes": run["peak"], "tokens": tokens.tolist(),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "decode_vs_forward_abs_err": err, "tol": SERVE_TOL}
    emit(line)
    if prefill_launches != cfg.num_layers or \
            launches != cfg.num_layers or launches_bf16 != 0:
        raise AssertionError(f"flash_attention launched "
                             f"{prefill_launches} times in the "
                             f"prefill and {launches} in all, expected "
                             f"{cfg.num_layers} and {cfg.num_layers}; its "
                             f"bf16 kernel {launches_bf16} times")
    if not (line["logits_finite"] and err <= SERVE_TOL):
        raise AssertionError(f"decode disagrees with forward: {line}")
    return launches, params, batch, cfg, {"tokens": full["tokens"],
                                          "logits": want}


# The bf16 serve's gate: over the f32 serve's prompt and decoded tokens, the
# bf16 model's last logits through the kernel may be at most this many
# times as far from the f32 model's as the bf16 model's through the plain
# version are.  The kernel keeps P to about 2^-17 as P_hi + P_lo, where the
# plain version keeps it in f32 (with P rounded to bf16 the ratio was
# 1.37); its other f32-level differences still flip single bf16 roundings,
# and the ratio is 1.2076 on an H100 in every run: the gate is that plus 5 %.
SERVE_BF16_GATE = 1.27


def serve_bf16_phase(fa, ref_fn, gate, batch) -> int:
    """``greedy_decode`` of Gemma-2 9B in bf16 (the JAX package's serving
    dtypes, ``DTYPE_OVERRIDES`` in ``repro.launch.dryrun``: bf16
    parameters and compute) at full width, on the f32 serve's prompt:
    prefill seconds, decode ms a step, peak memory and the bf16 kernel's
    launches (one per layer in the prefill, none in decode; the f32
    kernel none).  Then ``forward`` over ``gate["tokens"]`` twice, through
    the kernel and with the plain version in its place, each held to the
    f32 model's last logits ``gate["logits"]``.  Returns the bf16
    kernel's launches over the serve."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.utils import tree_leaves

    cfg = get_config("gemma2-9b").replace(param_dtype="bfloat16",
                                          compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # The f32 serve's weights rounded: init_params draws in f32 and casts.
    params = tfm.init_params(0, cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size()
                      for p in tree_leaves(params))

    run = timed_greedy_decode(fa, params, batch, cfg)
    tokens, logits = run["tokens"], run["logits"]
    prefill_s, decode_s = run["prefill_s"], run["decode_s"]
    launches_f32, launches = run["launches"]
    prefill_launches = run["prefill_launches"][1]
    _profile("gemma2-9b-bf16-prefill",
             lambda: tfm.prefill(params, batch, cfg))

    # The gate: the kernel's bf16 logits against the plain version's, each
    # against the f32 model's, over the same tokens.
    want = gate["logits"]
    full = {"tokens": gate["tokens"]}
    got = tfm.forward(params, full, cfg)[0][:, -1].float()
    launch = ops.flash_attention
    ops.flash_attention = ref_fn
    try:
        plain = tfm.forward(params, full, cfg)[0][:, -1].float()
    finally:
        ops.flash_attention = launch
    dist, rms = {}, {}
    for label, x in (("kernel", got), ("plain", plain)):
        dist[label] = float((x - want).abs().max())
        rms[label] = float((x - want).square().mean().sqrt())
    top = want.argmax(-1)
    line = {"phase": "serve", "arch": cfg.name, "dtype": "bfloat16",
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "param_bytes": param_bytes, "batch": SERVE_B,
            "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
            "init_s": init_s, "prefill_s": prefill_s,
            "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / prefill_s,
            "decode_s": decode_s, "decode_step_ms": decode_s / SERVE_NEW * 1e3,
            "decode_tokens_per_s": SERVE_B * SERVE_NEW / decode_s,
            "flash_attention_bf16_launches_prefill": prefill_launches,
            "flash_attention_bf16_launches_decode":
                launches - prefill_launches,
            "flash_attention_f32_launches": launches_f32,
            "peak_mem_bytes": run["peak"], "tokens": tokens.tolist(),
            "logits_finite": bool(torch.isfinite(logits.float()).all()),
            "gate_tokens": list(gate["tokens"].shape),
            "max_abs_to_f32_kernel": dist["kernel"],
            "max_abs_to_f32_plain": dist["plain"],
            "rms_to_f32_kernel": rms["kernel"], "rms_to_f32_plain": rms["plain"],
            "gate_ratio": SERVE_BF16_GATE,
            "argmax_agrees_f32_kernel": (got.argmax(-1) == top).tolist(),
            "argmax_agrees_f32_plain": (plain.argmax(-1) == top).tolist(),
            "argmax_agrees_kernel_plain":
                (got.argmax(-1) == plain.argmax(-1)).tolist()}
    emit(line)
    if prefill_launches != cfg.num_layers or \
            launches != cfg.num_layers or launches_f32 != 0:
        raise AssertionError(f"the bf16 kernel launched "
                             f"{prefill_launches} times in the "
                             f"prefill and {launches} in all, expected "
                             f"{cfg.num_layers} and {cfg.num_layers}; the "
                             f"f32 kernel {launches_f32} times, expected 0")
    if not (line["logits_finite"] and math.isfinite(dist["kernel"])
            and dist["kernel"] <= SERVE_BF16_GATE * dist["plain"]):
        raise AssertionError(f"the bf16 kernel's logits are further from "
                             f"the f32 model's than {SERVE_BF16_GATE}x the "
                             f"plain version's: {line}")
    return launches


def _profile(label: str, fn) -> None:
    """``fn()`` under ``torch.profiler``: device time by kernel and the
    device's idle share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    attn_ms = sum(r[1] for r in rows if "flash_attention" in r[0])
    # cuBLAS's and CUTLASS's matrix products, by their kernels' names.
    gemm_ms = sum(r[1] for r in rows
                  if any(w in r[0] for w in ("gemm", "nvjet", "cutlass")))
    emit({"phase": "profile", "run": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "flash_attention_device_ms": attn_ms, "gemm_device_ms": gemm_ms,
          "device_launches": sum(r[2] for r in rows),
          "top": [[name[:90], ms, cnt] for name, ms, cnt in rows[:10]]})


def serve_profile_phase(params, batch, cfg) -> None:
    """Where a full-width request's time goes: one prefill, then one
    decode step (after one unprofiled step), each under the profiler."""
    from repro_torch.models import transformer as tfm
    from repro_torch.training.serve import pad_caches

    out = {}
    _profile("gemma2-9b-prefill", lambda: out.update(
        zip(("logits", "caches"), tfm.prefill(params, batch, cfg))))
    prompt = batch["tokens"].shape[1]
    caches = pad_caches(out.pop("caches"), cfg, prompt + 2, prompt)
    token = torch.argmax(out.pop("logits")[:, -1], dim=-1)[:, None]
    tfm.decode_step(params, token, caches, prompt, cfg)
    _profile("gemma2-9b-decode-step",
             lambda: tfm.decode_step(params, token, caches, prompt, cfg))


# ---------------------------------------------------------------------------
# The other mixers and front ends: MoE with qk_norm, mamba, the vision and
# audio front ends with cross-attention, xLSTM.
# ---------------------------------------------------------------------------

# Each configuration served at its published widths: name, dtype, layers
# kept (None: all of them), requests, prompt (the whole sequence: the
# VLM's 256 patches and 1,792 tokens; whisper's 64 tokens beside its
# 1,500 encoder frames).  The MoE configurations run dropless (capacity
# factor E / k), so that the prefill and the decode steps route alike.
# Jamba and Qwen3-MoE run in f32 too, where the gate is SERVE_TOL: Jamba
# at its 8-layer cut (53 GB of f32 params), Qwen3-MoE at 4 layers, the
# most that fits beside its dropless buffers (its 8 would be 85 GB of
# params); Kimi K2's one layer is 68 GB in f32, and runs in bf16 only.
# The dense configurations registered last serve here too, in bf16:
# phi4-mini-3.8b whole, llama3-405b at one of its 126 layers (7.39 B
# params, 14.8 GB; its 405 B fit no card).
MIXER_RUNS = (
    ("qwen3-moe-235b-a22b", "bfloat16", 8, 2, 2048),
    ("qwen3-moe-235b-a22b", "float32", 4, 2, 2048),
    ("kimi-k2-1t-a32b", "bfloat16", 1, 1, 2048),
    ("jamba-v0.1-52b", "bfloat16", 8, 2, 2048),
    ("jamba-v0.1-52b", "float32", 8, 2, 2048),
    ("internvl2-2b", "float32", None, 2, 2048),
    ("whisper-tiny", "float32", None, 2, 64),
    ("xlstm-125m", "float32", None, 2, 2048),
    ("phi4-mini-3.8b", "bfloat16", None, 2, 2048),
    ("llama3-405b", "bfloat16", 1, 1, 2048),
)
MIXER_REF_NEW = 8
MIXER_REF_TOL = 1e-4
# The gate (`decode_gate`): a prefill over the prompt and the decoded
# tokens against the decoded path's last logits.  The prefill routes each
# token as the decoded path did: the two paths round differently, and a
# router whose k-th and (k+1)-th experts lie within that rounding takes
# one on one path and the other on the other; with 128 experts and top-8
# such near-ties are common, and one flip moves a token's output by a whole
# expert's share, which the later layers and a mamba state carry on.  So
# that routing cannot hide a fault of the decoded path's own routing, each
# expert it took must lie within ROUTE_TIE of its prefill router's k-th
# probability.  f32: SERVE_TOL, JAX's own consistency bound.  bf16: the
# relative L2 distance of each row, ≤ MIXER_BF16_REL_L2, twice the largest
# rounding-only reading (PERF.md §6 has the readings, and those of the
# decoded path broken on purpose, `scripts/mixers_phase.py --parts
# faults`: a lost state at Jamba reads far above it; one lost token of
# 2,064 at Qwen3-MoE and Kimi K2 reads under it, and is caught in f32:
# Qwen3-MoE's 4-layer run here, Kimi K2 only at its reduced width).
MIXER_BF16_REL_L2 = 0.05
ROUTE_TIE = {"f32": 1e-5, "bf16": 5e-3}


def attention_launches(cfg, new_tokens: int):
    """The flash kernel's launches in ``greedy_decode`` of ``new_tokens``,
    counted from the configuration: ``(prefill, after it)``.  The prefill
    runs every self-attention layer, and for the audio front end the
    encoder's layers and every decoder block's cross-attention; after it
    ``greedy_decode`` encodes the audio once more (as JAX's does) and each
    decode step runs the cross-attention at one query (decode
    self-attention is plain torch)."""
    attn = cfg.num_periods * sum(s.mixer == "attn" for s in cfg.pattern)
    if cfg.frontend != "audio_stub":
        return attn, 0
    cross = cfg.num_layers
    return (attn + cfg.encoder_layers + cross,
            cfg.encoder_layers + cross * new_tokens)


def mixer_reference_run(fa, name: str) -> dict:
    """The reduced configuration's greedy decoding on the card against the
    CPU, with the same weights and batch: the same tokens, the last logits
    within MIXER_REF_TOL, and the f32 kernel's launches as counted from the
    configuration."""
    from repro_torch.configs import get_config

    cfg = get_config(name, reduced=True)
    tokens, cpu_tokens, err, launches = greedy_card_against_cpu(
        fa, cfg, MIXER_REF_NEW)
    want = sum(attention_launches(cfg, MIXER_REF_NEW))
    line = {"phase": "mixers", "run": f"{name}-reduced", "layers":
            cfg.num_layers, "d_model": cfg.d_model,
            "tokens_equal": torch.equal(tokens, cpu_tokens),
            "logits_abs_err": err, "tol_logits_abs": MIXER_REF_TOL,
            "launches": launches, "launches_expected": want}
    emit(line)
    if not (line["tokens_equal"] and line["logits_abs_err"] <= MIXER_REF_TOL
            and line["launches"] == {"f32": want, "bf16": 0}):
        raise AssertionError(f"the reduced {name} on the card disagrees "
                             f"with the CPU: {line}")
    return line


def slstm_launches_per_token(params, cfg, tokens: int = 8) -> float:
    """Device launches a token of one sLSTM layer's loop, counted by the
    profiler over ``tokens`` tokens (the loop's own, its projections
    before and after it included, spread over the tokens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.xlstm import slstm_apply
    from repro_torch.utils import tree_map

    i = next(i for i, s in enumerate(cfg.pattern) if s.mixer == "slstm")
    p = tree_map(lambda a: a[0], params["layers"][f"b{i}"]["slstm"])
    x = torch.randn(2, tokens, cfg.d_model, device=DEVICE)
    slstm_apply(p, x, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        slstm_apply(p, x, cfg)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n / tokens


@contextlib.contextmanager
def gate_records():
    """While entered, each ``block_apply`` call of the model appends its
    output at the last position ((B, d) f32) to ``rec["x"]``; each MoE
    layer its router's probabilities ((T, E) f32) and the experts it
    takes ((T, k), in the order ``moe_apply`` takes them) to
    ``rec["moe"]``; each mamba layer its new state h to ``rec["h"]``.
    Yields ``rec``."""
    from repro_torch.models import transformer as tfm

    rec = {"x": [], "moe": [], "h": []}
    block, moe, mamba = (tfm.block_apply, tfm.moe_apply,
                         tfm._RECURRENT["mamba"])

    def block_rec(*args, **kwargs):
        out = block(*args, **kwargs)
        rec["x"].append(out[0][:, -1].float())
        return out

    def moe_rec(params, x, *, top_k, **kwargs):
        probs = torch.softmax(x.to(torch.float32) @ params["router"], -1)
        rec["moe"].append((probs, torch.topk(probs, top_k, dim=-1)[1]))
        return moe(params, x, top_k=top_k, **kwargs)

    def mamba_rec(*args, **kwargs):
        y, cache = mamba(*args, **kwargs)
        rec["h"].append(cache["h"])
        return y, cache

    tfm.block_apply, tfm.moe_apply = block_rec, moe_rec
    tfm._RECURRENT["mamba"] = mamba_rec
    try:
        yield rec
    finally:
        tfm.block_apply, tfm.moe_apply = block, moe
        tfm._RECURRENT["mamba"] = mamba


class _RoutedTorch:
    """``torch``, but ``topk`` hands out the next of ``routes`` (the
    experts, (T, k)) with the given probabilities at them: a
    ``moe_apply`` given it as its module's ``torch`` routes each token as
    ``routes`` say."""

    def __init__(self, routes):
        self.routes = list(routes)

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1):
        e = self.routes.pop(0)
        return torch.gather(probs, dim, e), e


@contextlib.contextmanager
def routed_as(routes):
    """While entered, the MoE layers route each token as ``routes`` (one
    (T, k) tensor a layer call, in call order) say."""
    from repro_torch.models import moe

    moe.torch = _RoutedTorch(routes)
    try:
        yield
    finally:
        moe.torch = torch


def decoded_routes(dec: dict, B: int, P: int, n: int, M: int) -> list:
    """The experts the decoded path took (``dec``: the records of
    ``greedy_decode`` of n tokens after P prompt positions), one (B·(P+n),
    k) tensor for each of the M MoE layers, in the order of a prefill over
    all P + n positions."""
    return [torch.cat([dec["moe"][m][1].view(B, P, -1)]
                      + [dec["moe"][(1 + j) * M + m][1].view(B, 1, -1)
                         for j in range(n)], dim=1).view(B * (P + n), -1)
            for m in range(M)]


def gate_anatomy(dec: dict, free: dict, routed: dict, routes: list,
                 B: int, P: int, n: int) -> dict:
    """Where the decoded path (``dec``) and a prefill over all P + n
    positions that routes on its own (``free``) part, layer by layer: the
    relative L2 distance of each block's output at the last position (a
    row each); for each MoE layer the tokens whose experts differ (as sets)
    in the prompt and among the decoded tokens, whether the last token's
    do, and the router's margin (the k-th probability less the (k+1)-th,
    in ``free``) at the least and the most decisive of them; for each mamba
    layer the relative L2 distance of its last state.  Then, for the
    prefill routed as the decoded path (``routed``): each MoE layer's
    largest shortfall of a taken expert's probability below its router's
    own k-th (0 where it takes what its router would)."""
    def rel(a, b):
        return ((a - b).flatten(1).norm(dim=1)
                / b.flatten(1).norm(dim=1)).tolist()

    L, M, Mm = len(free["x"]), len(free["moe"]), len(free["h"])
    out = {"block_out_rel_l2": [rel(dec["x"][n * L + i], free["x"][i])
                                for i in range(L)]}
    if M:
        flips, shortfall = [], []
        for m in range(M):
            probs, e_free = free["moe"][m]
            k = e_free.shape[1]
            top = torch.topk(probs, k + 1, dim=-1)[0]
            margin = (top[:, k - 1] - top[:, k]).view(B, P + n)
            differ = (routes[m].sort(-1)[0] != e_free.sort(-1)[0]).any(-1)
            differ = differ.view(B, P + n)
            flips.append({
                "prompt": int(differ[:, :P].sum()),
                "decoded": int(differ[:, P:].sum()),
                "last": differ[:, -1].tolist(),
                "margin_flipped": ([float(margin[differ].min()),
                                    float(margin[differ].max())]
                                   if differ.any() else None),
                "margin_min": float(margin.min())})
            probs = routed["moe"][m][0]
            kth = torch.topk(probs, k, dim=-1)[0][:, -1]
            taken = torch.gather(probs, 1, routes[m]).min(-1)[0]
            shortfall.append(float((kth - taken).clamp(min=0).max()))
        out["moe_flips"] = flips
        out["route_shortfall"] = shortfall
    if Mm:
        out["mamba_h_rel_l2"] = [rel(dec["h"][n * Mm + i], free["h"][i])
                                 for i in range(Mm)]
    return out


def decode_gate(params, batch, cfg, P: int, n: int = SERVE_NEW) -> dict:
    """``greedy_decode`` of n tokens (P prompt positions), then the gate:
    one prefill over the prompt and the decoded tokens, routed as the
    decoded path routed each token (a router's near-tie can fall the
    other way on the two paths; `gate_anatomy` shows where), against the
    decoded path's last logits: the largest absolute difference and the
    relative L2 distance of each row; the same for a prefill that routes
    on its own (``free_``); and `gate_anatomy`."""
    from repro_torch.models import transformer as tfm
    from repro_torch.training.serve import greedy_decode

    with gate_records() as dec:
        tokens, logits = greedy_decode(params, batch, cfg, n)
    full = dict(batch, tokens=torch.cat([batch["tokens"], tokens], dim=1))
    B = tokens.shape[0]
    M = len(dec["moe"]) // (1 + n)
    routes = decoded_routes(dec, B, P, n, M)
    with gate_records() as free:
        want_free = tfm.prefill(params, full, cfg)[0][:, -1].float()
    with gate_records() as routed, routed_as(routes):
        want = tfm.prefill(params, full, cfg)[0][:, -1].float()
    got = logits[:, 0].float()

    def dist(a, b):
        return (float((a - b).abs().max()),
                ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist())

    out = {"tokens": tokens, "logits": logits}
    out["max_abs"], out["rel_l2"] = dist(got, want)
    out["free_max_abs"], out["free_rel_l2"] = dist(got, want_free)
    out["argmax_agrees"] = (got.argmax(-1) == want.argmax(-1)).tolist()
    out["anatomy"] = gate_anatomy(dec, free, routed, routes, B, P, n)
    out["routes"] = routes
    return out


# The cache-entry check: each entry a decode step writes against the one a
# prefill over the same tokens, routed as the decoded path was, writes at
# the same position; the relative L2 distance at each position.  f32: sums
# in other orders through the layers; bf16: a few ulps (2^-8) of the
# entries, against 1.0 for an entry never written.
CACHE_TOL = {"f32": 1e-3, "bf16": 0.05}


def decode_recording(params, batch, cfg, n: int, drop=None):
    """``greedy_decode`` of n tokens, step by step as it runs them, that
    keeps what the decode steps write: the final caches and each mamba
    layer's state after each step.  ``drop``: a position whose cache
    write is skipped (every layer forgets that token's keys, values or
    state), to show that the check catches it.  Returns ``(tokens,
    logits, caches, states)``, ``states[j]``: the mamba layers' ``h``
    (each (periods, B, d_inner, N)) after decode step j, by block."""
    from repro_torch.models import transformer as tfm
    from repro_torch.training.serve import apply_cache_deltas, pad_caches

    P = batch["tokens"].shape[1] + (cfg.prefix_tokens
                                    if cfg.frontend == "vision_stub" else 0)
    logits, caches = tfm.prefill(params, batch, cfg)
    caches = pad_caches(caches, cfg, P + n, P)
    enc_kv = None
    if cfg.frontend == "audio_stub":
        enc_kv = tfm.encoder_kv(tfm._first_cross_params(params, cfg),
                                tfm._encode_audio(params, batch, cfg), cfg)
    tokens, states = [], []
    for pos in range(P, P + n):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, deltas = tfm.decode_step(params, nxt, caches, pos, cfg,
                                         enc_kv=enc_kv)
        if pos != drop:
            caches = apply_cache_deltas(caches, deltas, pos, cfg)
        states.append({name: c["mixer"]["h"].clone()
                       for name, c in caches.items() if "h" in c["mixer"]})
        tokens.append(nxt[:, 0])
    return torch.stack(tokens, dim=1), logits, caches, states


@contextlib.contextmanager
def scan_states():
    """While entered, each mamba layer's selective scan records the state
    after every one of its last ``rec["keep"]`` positions (``rec["h"]``:
    one (B, keep, d_inner, N) tensor a layer call)."""
    from repro_torch.models import ssm

    rec = {"keep": 0, "h": []}
    scan, chunk_fn = ssm.selective_scan, ssm._scan_chunk

    def chunk_rec(params, xc, h, d_state, dt_rank, valid):
        dA, dBu, _ = ssm._ssm_coeffs(params, xc, d_state, dt_rank,
                                     valid=valid)
        A_cum, B_cum = ssm._scan(dA, dBu)
        h_t = A_cum * h[:, None] + B_cum
        tail = rec.pop("tail", None)
        rec["tail"] = (h_t if tail is None else torch.cat([tail, h_t], 1)
                       )[:, -(rec["keep"] + xc.shape[1]):]
        return chunk_fn(params, xc, h, d_state, dt_rank, valid)

    def scan_rec(params, xz, d_state, dt_rank, chunk, *args, **kwargs):
        out = scan(params, xz, d_state, dt_rank, chunk, *args, **kwargs)
        L = xz.shape[1]
        c = min(chunk, L)
        pad = -(-L // c) * c - L       # identity steps after the last
        tail = rec.pop("tail")
        rec["h"].append(tail[:, :tail.shape[1] - pad][:, -rec["keep"]:])
        return out

    ssm.selective_scan, ssm._scan_chunk = scan_rec, chunk_rec
    try:
        yield rec
    finally:
        ssm.selective_scan, ssm._scan_chunk = scan, chunk_fn


def cache_entry_check(params, batch, cfg, P: int, n: int, routes,
                      tokens=None, drop=None) -> dict:
    """Position by position, each cache entry the decode steps write
    (`decode_recording`) against the one a prefill over the prompt and the
    decoded tokens, routed as the decoded path was (``routes``,
    `decoded_routes`), writes at the same position: for every attention
    layer the relative L2 distance of its k and v entries at positions P
    .. P + n − 1, for every mamba layer that of the state after each of
    them.  Returns the distances by layer and the worst one with its
    layer and position; ``tokens``, if given, must be what the decoding
    decodes."""
    from repro_torch.models import transformer as tfm

    got_tokens, _, caches, states = decode_recording(params, batch, cfg, n,
                                                     drop)
    full = dict(batch, tokens=torch.cat([batch["tokens"], got_tokens],
                                        dim=1))
    with scan_states() as rec, routed_as(list(routes)):
        rec["keep"] = n
        _, want = tfm.prefill(params, full, cfg)

    def rel(a, b):
        # a, b: positions first; one distance a position.
        a, b = a.float().flatten(1), b.float().flatten(1)
        return ((a - b).norm(dim=1)
                / b.norm(dim=1).clamp(min=1e-30)).tolist()

    out, worst = {}, (0.0, None, None)
    mamba = iter(rec["h"])
    for period in range(cfg.num_periods):
        for i, spec in enumerate(cfg.pattern):
            name = f"b{i}"
            if spec.mixer == "attn":
                if 0 < spec.window < P + n:
                    raise ValueError("the check reads full-length caches; "
                                     f"{name} is a window of {spec.window}")
                c, w = caches[name]["mixer"], want[name]["mixer"]
                # (B, positions, KV, hd) -> positions first.
                dist = [max(x, y) for x, y in zip(
                    rel(c["k"][period][:, P:P + n].transpose(0, 1),
                        w["k"][period][:, P:P + n].transpose(0, 1)),
                    rel(c["v"][period][:, P:P + n].transpose(0, 1),
                        w["v"][period][:, P:P + n].transpose(0, 1)))]
            elif spec.mixer == "mamba":
                h_want = next(mamba)                 # (B, n, d_inner, N)
                h_got = torch.stack([s[name][period] for s in states], 1)
                dist = rel(h_got.transpose(0, 1), h_want.transpose(0, 1))
            else:
                continue
            out[f"{name}[{period}]"] = dist
            j = max(range(n), key=dist.__getitem__)
            if dist[j] > worst[0]:
                worst = (dist[j], f"{name}[{period}]", P + j)
    return {"rel_l2": out, "worst": worst[0], "worst_layer": worst[1],
            "worst_position": worst[2],
            "tokens_equal": (None if tokens is None
                             else torch.equal(got_tokens, tokens))}


def mixer_full_width_run(fa, name: str, dtype: str, layers, B: int,
                         seq: int, probe=None) -> dict:
    """``greedy_decode`` of SERVE_NEW tokens at the published widths, depth
    cut to ``layers``, after one untimed run of the same decoding that
    warms its shapes: prefill s, decode ms a step, peak memory, parameter
    bytes, each kernel's launches against the count from the
    configuration, and the gate (prefill over the prompt and the decoded
    tokens against the decoded path's last logits), with where the two
    paths part (`gate_anatomy`, from the warm-up run, which must decode
    the same tokens).  An MoE configuration runs the gate dropless, then
    its published capacity factor once more, warmed and timed: the
    configuration's own numbers.  ``probe(params, batch, cfg, P)``, if
    given (P: the prompt's positions),
    runs on the gate's model before it is freed and its dict goes into
    the line under ``probe``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch
    from repro_torch.training.serve import greedy_decode
    from repro_torch.utils import tree_leaves

    published = get_config(name)
    cuts = {"dtype": f"{published.param_dtype} -> {dtype}"}
    cfg = published.replace(param_dtype=dtype, compute_dtype=dtype)
    if layers is not None and layers != published.num_layers:
        cfg = cfg.replace(num_layers=layers)
        cuts["layers"] = f"{published.num_layers} -> {layers}"
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
        cuts["capacity_factor"] = (f"{published.capacity_factor} -> "
                                   f"{cfg.capacity_factor} (dropless)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(0, cfg, device=DEVICE)
    batch = make_batch(1, cfg, seq, B, kind="prefill", device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in tree_leaves(params))

    P = seq if cfg.frontend == "vision_stub" else batch["tokens"].shape[1]
    gate = decode_gate(params, batch, cfg, P)
    kernel = "bf16" if dtype == "bfloat16" else "f32"
    cache = None
    if cfg.num_experts or any(s.mixer == "mamba" for s in cfg.pattern):
        cache = cache_entry_check(params, batch, cfg, P, SERVE_NEW,
                                  gate["routes"], tokens=gate["tokens"])
        cache["tol"] = CACHE_TOL[kernel]
        del cache["rel_l2"]
    run = timed_greedy_decode(fa, params, batch, cfg)
    tokens, logits = run["tokens"], run["logits"]
    want_prefill, want_rest = attention_launches(cfg, SERVE_NEW)
    prefill = dict(zip(("f32", "bf16"), run["prefill_launches"]))
    total = dict(zip(("f32", "bf16"), run["launches"]))
    line = {"phase": "mixers", "run": name, "dtype": dtype,
            "reduced": cuts, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "hd": cfg.hd, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads,
            "params": tfm.count_params(cfg),
            "active_params": tfm.count_active_params(cfg),
            "param_bytes": param_bytes, "batch": B,
            "prompt_tokens": batch["tokens"].shape[1],
            "prompt_positions": P,
            "encoder_frames": cfg.encoder_seq or None,
            "new_tokens": SERVE_NEW, "init_s": init_s,
            "init_peak_mem_bytes": init_peak,
            "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "decode_step_ms": run["decode_s"] / SERVE_NEW * 1e3,
            "decode_tokens_per_s": B * SERVE_NEW / run["decode_s"],
            "peak_mem_bytes": run["peak"],
            "device_total_bytes":
                torch.cuda.get_device_properties(0).total_memory,
            "launches_prefill": prefill, "launches": total,
            "launches_expected": {"prefill": want_prefill,
                                  "after_prefill": want_rest,
                                  "kernel": kernel},
            "logits_finite": bool(torch.isfinite(logits.float()).all()),
            "gate_max_abs": gate["max_abs"], "gate_rel_l2": gate["rel_l2"],
            "gate": (f"rel_l2 <= {MIXER_BF16_REL_L2}" if kernel == "bf16"
                     else f"max_abs <= {SERVE_TOL}")
            + f"; route_shortfall <= {ROUTE_TIE[kernel]}",
            "gate_free_max_abs": gate["free_max_abs"],
            "gate_free_rel_l2": gate["free_rel_l2"],
            "argmax_agrees": gate["argmax_agrees"],
            "warm_up_bitwise": (torch.equal(gate["tokens"], tokens) and
                                torch.equal(gate["logits"], logits)),
            "gate_anatomy": gate["anatomy"], "cache_check": cache,
            "tokens": tokens.tolist()}
    if name == "xlstm-125m":
        line["slstm_launches_per_token"] = slstm_launches_per_token(params,
                                                                    cfg)
    del gate, run, logits
    if cfg.num_experts:
        pub = cfg.replace(capacity_factor=published.capacity_factor)
        greedy_decode(params, batch, pub, SERVE_NEW)          # warm-up
        prun = timed_greedy_decode(fa, params, batch, pub)
        line["published_capacity"] = {
            "capacity_factor": pub.capacity_factor,
            "prefill_s": prun["prefill_s"], "decode_s": prun["decode_s"],
            "decode_step_ms": prun["decode_s"] / SERVE_NEW * 1e3,
            "peak_mem_bytes": prun["peak"],
            "launches_prefill": dict(zip(("f32", "bf16"),
                                         prun["prefill_launches"])),
            "launches": dict(zip(("f32", "bf16"), prun["launches"])),
            "logits_finite": bool(torch.isfinite(
                prun["logits"].float()).all()),
            "tokens_equal_dropless": torch.equal(prun["tokens"], tokens)}
        del prun
    if probe is not None:
        line["probe"] = probe(params, batch, cfg, P)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    other = "f32" if kernel == "bf16" else "bf16"
    if not (prefill[kernel] == want_prefill and prefill[other] == 0
            and total[kernel] == want_prefill + want_rest
            and total[other] == 0):
        raise AssertionError(f"{name}: the flash kernels launched "
                             f"{prefill} times in the prefill and {total} "
                             f"in all; the configuration counts "
                             f"{want_prefill} and {want_prefill + want_rest}"
                             f" of the {kernel} kernel")
    ok = (line["gate_max_abs"] <= SERVE_TOL if kernel == "f32"
          else max(line["gate_rel_l2"]) <= MIXER_BF16_REL_L2)
    ok &= max(line["gate_anatomy"].get("route_shortfall", [0.0])) <= \
        ROUTE_TIE[kernel]
    if cache is not None:
        ok &= cache["tokens_equal"] and cache["worst"] <= cache["tol"]
    if not (line["logits_finite"] and ok):
        raise AssertionError(f"{name}: decode disagrees with prefill: "
                             f"{line}")
    pub = line.get("published_capacity")
    if pub and not (pub["logits_finite"] and pub["launches"] == total
                    and pub["launches_prefill"] == prefill):
        raise AssertionError(f"{name} at its published capacity factor: "
                             f"{pub}")
    return line


def mixers_phase(fa) -> dict:
    """Every configuration of MIXER_RUNS: the reduced one on the card
    against the CPU, then served at full width.  Returns each kernel's
    launches over the full-width serves, by configuration."""
    launches = {}
    for name, dtype, layers, B, seq in MIXER_RUNS:
        if name not in launches:
            mixer_reference_run(fa, name)
        line = mixer_full_width_run(fa, name, dtype, layers, B, seq)
        n = launches.setdefault(name, {"f32": 0, "bf16": 0})
        for kernel in n:
            n[kernel] += line["launches"][kernel]
    return launches


# ---------------------------------------------------------------------------
# The compiled trajectory and the batched Monte-Carlo sweep.
# ---------------------------------------------------------------------------

class _NaNTorch:
    """``torch``, but ``empty`` and ``empty_like`` hand out NaN: a kernel
    wrapper given it as its module's ``torch`` allocates every output
    poisoned, so an element its kernel leaves unwritten stays NaN."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*size, **kwargs):
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        return torch.full(size, math.nan, **kwargs)

    @staticmethod
    def empty_like(x, **kwargs):
        return torch.full_like(x, math.nan, **kwargs)


def poisoned_outputs(module, fn):
    """``fn()``, with ``module`` (a kernel wrapper's) allocating its
    outputs filled with NaN."""
    saved = module.torch
    module.torch = _NaNTorch()
    try:
        return fn()
    finally:
        module.torch = saved


# The sweep on the main path: 8 seeds x the 5 SNRs of ``snr-sweep``, and a
# COTAF sweep of 8 seeds at 40 dB.
MC_SEEDS = 8
MC_ROUNDS = 5


def stacked_round_inputs(B, K, C, d, dtype):
    """B trajectories' ``round_inputs``, each from a seed of its own,
    stacked along a leading axis."""
    per = [round_inputs(K, C, d, dtype, seed=K + C + d + b) for b in range(B)]
    return tuple(torch.stack(x) for x in zip(*per))


def batched_kernel_phase(kmod, omod, cwfl_ref, ota_ref):
    """The trajectory axis of kernels 1 and 3 against their plain versions
    on the card, each output poisoned with NaN before its launch: one
    launch computes B rounds, each equal to the unbatched launch on its
    trajectory's inputs, bit for bit (checked at the first, a middle and
    the last trajectory).  ``cwfl_round`` at the sweep's B = 40, and its
    guarded variant on poisoned inputs (the dynamic sweeps' fault
    rounds), each timed; ``ota_aggregate`` at
    the COTAF sweep's B = 8, C = 1, at B = 40 and at decentralized's
    C = K = 50 on the ring (B = 8), with ``torch.baddbmm(N, W, S)``
    (TF32 off) as its one-call yardstick.  Returns the kernels summary's
    rows (without their launch counts)."""
    import dataclasses

    bw, peak, *_ = card_peaks(torch.cuda.get_device_name(0))
    B, K, C, d = MC_SEEDS * 5, 50, 3, 184214
    rows = {}
    for guard in (False, True):
        args = stacked_round_inputs(B, K, C, d, torch.float32)
        if guard:
            per = [poison(tuple(x[b] for x in args), seed=b)
                   for b in range(B)]
            args = tuple(torch.stack(x) for x in zip(*per))
        new, cons = poisoned_outputs(
            kmod, lambda: kmod.cwfl_round(*args, guard=guard))
        ref_new, ref_cons = cwfl_ref(*args, guard=guard)
        torch.cuda.synchronize()
        err = max(float((new - ref_new).abs().max()),
                  float((cons - ref_cons).abs().max()))
        bitwise = []
        for b in (0, B // 2, B - 1):
            one_new, one_cons = kmod.cwfl_round(*(x[b] for x in args),
                                                guard=guard)
            bitwise.append(bool(torch.equal(one_new, new[b])
                                and torch.equal(one_cons, cons[b])))
        finite = bool(torch.isfinite(new).all() and torch.isfinite(cons).all())
        name = "cwfl_round_guard" if guard else "cwfl_round"
        line = {"phase": "kernel", "kernel": name, "shape": "batched",
                "B": B, "K": K, "C": C, "d": d, "max_abs_err": err,
                "tol": F32_ATOL, "finite": finite,
                "bitwise_equal_to_unbatched": bitwise}
        nbytes = B * (kmod.hbm_bytes_model(K, C, d)["fused_bytes"]
                      + 4 * (2 * C * K + C * C))
        flops = B * d * (2 * C * K + 2 * C * C + 2 * K * C + 3 * C)
        launch = lambda: kmod.cwfl_round(*args, guard=guard)   # noqa: E731
        plain = lambda: cwfl_ref(*args, guard=guard)           # noqa: E731
        line.update(ms=time_cold(launch, reps=10),
                    device_ms=device_ms(launch, reps=10),
                    plain_ms=time_cold(plain, reps=5),
                    plain_device_ms=device_ms(plain, reps=5),
                    bytes=nbytes, bound_ms_bytes=nbytes / bw * 1e3,
                    bound_ms_operations=flops / peak * 1e3)
        above_bound(f"{name} batched", {k: line[k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms")},
            line["bound_ms_bytes"])
        rows["cwfl_guard" if guard else "cwfl"] = {
            "name": f"{name}[batched S={B}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cwfl_round.cu",
            "replaces": ("src/repro/kernels/cwfl_round.py:124" if guard
                         else "src/repro/kernels/cwfl_round.py:42"),
            "launches": None, "max_abs_err": err, "ms": line["ms"],
            "plain_ms": line["plain_ms"],
            "bound_ms": max(line["bound_ms_bytes"],
                            line["bound_ms_operations"]),
            "bound_by": ("bytes" if line["bound_ms_bytes"]
                         >= line["bound_ms_operations"] else "operations"),
            "library_ms": None, "device_ms": line["device_ms"],
            "plain_device_ms": line["plain_device_ms"],
            "shape": {"S": B, "K": K, "C": C, "d": d}}
        emit(line)
        if not (err <= F32_ATOL and all(bitwise) and (finite or guard)):
            raise AssertionError(f"the batched {name} disagrees with its "
                                 f"plain version or its unbatched launch: "
                                 f"{line}")
        del args, new, cons, ref_new, ref_cons

    for label, B, C in (("cotaf", MC_SEEDS, 1), ("s40", 5 * MC_SEEDS, 1),
                        ("decentralized", MC_SEEDS, K)):
        g = torch.Generator(DEVICE).manual_seed(B + C)
        s = torch.randn(B, K, d, generator=g, device=DEVICE)
        w = torch.rand(B, C, K, generator=g, device=DEVICE)
        w = w / w.sum(-1, keepdim=True)
        n = 1e-2 * torch.randn(B, C, d, generator=g, device=DEVICE)
        before = omod.launches
        out = poisoned_outputs(omod, lambda: omod.ota_aggregate(s, w, n))
        torch.cuda.synchronize()
        a_call = omod.launches - before
        ref = ota_ref(s, w, n)
        err = float((out - ref).abs().max())
        bitwise = [bool(torch.equal(omod.ota_aggregate(s[b], w[b], n[b]),
                                    out[b])) for b in (0, B // 2, B - 1)]
        finite = bool(torch.isfinite(out).all())
        lib = lambda: torch.baddbmm(n, w, s)   # noqa: E731
        lib_err = float((lib() - ref).abs().max())
        nbytes = 4 * B * (K * d + 2 * C * d + C * K)
        flops = B * d * (2 * C * K + C)
        launch = lambda: omod.ota_aggregate(s, w, n)   # noqa: E731
        plain = lambda: ota_ref(s, w, n)               # noqa: E731
        line = {"phase": "kernel", "kernel": "ota_aggregate",
                "shape": f"batched_{label}", "B": B, "K": K, "C": C, "d": d,
                "plan": dataclasses.asdict(omod.launch_plan(
                    K, C, d, torch.float32, torch.float32, batch=B)),
                "launches_a_call": a_call, "max_abs_err": err,
                "tol_abs_and_rel": OTA_TOL[torch.float32], "finite": finite,
                "bitwise_equal_to_unbatched": bitwise,
                "ms": time_cold(launch, reps=10),
                "device_ms": device_ms(launch, reps=10),
                "plain_ms": time_cold(plain, reps=5),
                "plain_device_ms": device_ms(plain, reps=5),
                "library": "torch.baddbmm", "library_max_abs_err": lib_err,
                "library_ms": time_cold(lib, reps=10),
                "library_device_ms": device_ms(lib, reps=10),
                "bytes": nbytes, "bound_ms_bytes": nbytes / bw * 1e3,
                "bound_ms_operations": flops / peak * 1e3}
        emit(line)
        above_bound(f"ota_aggregate batched_{label}", {k: line[k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms")}, line["bound_ms_bytes"])
        tol = OTA_TOL[torch.float32]
        if not (bool(torch.all((out - ref).abs() <= tol + tol * ref.abs()))
                and finite and all(bitwise) and a_call == 1
                and lib_err <= tol):
            raise AssertionError(f"the batched ota_aggregate disagrees at "
                                 f"{label}: {line}")
        rows[label] = line
        del s, w, n, out, ref
    cotaf, s40 = rows["cotaf"], rows["s40"]
    ota_row = {
        "name": f"ota_aggregate[batched S={MC_SEEDS} C=1]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ota_aggregate.cu",
        "replaces": "src/repro/kernels/ota_aggregate.py:38",
        "launches": None, "max_abs_err": cotaf["max_abs_err"],
        "ms": cotaf["ms"], "plain_ms": cotaf["plain_ms"],
        "bound_ms": max(cotaf["bound_ms_bytes"],
                        cotaf["bound_ms_operations"]),
        "bound_by": ("bytes" if cotaf["bound_ms_bytes"]
                     >= cotaf["bound_ms_operations"] else "operations"),
        "library_ms": cotaf["library_ms"], "library": "torch.baddbmm",
        "device_ms": cotaf["device_ms"],
        "plain_device_ms": cotaf["plain_device_ms"],
        "library_device_ms": cotaf["library_device_ms"],
        "shape": {"S": MC_SEEDS, "K": K, "C": 1, "d": d},
        "ms_s40": s40["ms"], "device_ms_s40": s40["device_ms"],
        "bound_ms_s40": s40["bound_ms_bytes"],
        "library_device_ms_s40": s40["library_device_ms"],
        "device_ms_c50": rows["decentralized"]["device_ms"],
        "bound_ms_c50": max(rows["decentralized"]["bound_ms_bytes"],
                            rows["decentralized"]["bound_ms_operations"]),
        "library_device_ms_c50": rows["decentralized"]["library_device_ms"]}
    return rows["cwfl"], rows["cwfl_guard"], ota_row


def histories_equal(a: dict, b: dict) -> dict:
    """How far two runs' histories are apart (on the card or the CPU,
    compared on the CPU): the largest relative loss gap, accuracy gap,
    final-params gap and whether the scenario records agree, and whether
    all of it is bitwise."""
    from repro_torch.utils import tree_leaves

    def host(x):
        return torch.as_tensor(x).cpu()

    la, lb = host(a["train_loss"]), host(b["train_loss"])
    aa, ab = host(a["test_acc"]), host(b["test_acc"])
    pa = [host(x) for x in tree_leaves(a["final_params"])]
    pb = [host(x) for x in tree_leaves(b["final_params"])]
    ra, rb = a.get("scenario"), b.get("scenario")
    if isinstance(ra, dict) and isinstance(rb, dict):
        # run_rounds' records are tensors, run_federated's lists.
        rec = sorted(ra) == sorted(rb) and all(
            torch.equal(host(ra[k]), host(rb[k])) for k in ra)
    else:
        rec = ra == rb
    bitwise = (torch.equal(la, lb) and torch.equal(aa, ab) and rec
               and all(torch.equal(x, y) for x, y in zip(pa, pb)))
    return {"bitwise": bool(bitwise),
            "loss_rel": float(((la - lb).abs() / lb.abs()).max()),
            "acc_abs": float((aa - ab).abs().max()),
            "param_abs": max(float((x - y).abs().max())
                             for x, y in zip(pa, pb)),
            "records_equal": bool(rec)}


def scan_window(prof, rounds: int, skip_first: bool = False) -> dict:
    """From a profile of a whole run with `PhaseTimers` (their
    record_function ranges): over the window from the first ``execute``
    range to the last — in scan mode rounds 2..T (draws, replays, the
    final wait for the device), in loop mode every round (``skip_first``
    drops round 1) — less any ``trace_compile`` range inside it (a
    capture, before which the device has finished the rounds so far): the
    device work a round (kernels and copies, by the union of their
    intervals in the window), the launches a round, the device's idle
    share of the window's wall time, the launches of each round kernel,
    the ten kernels of most device time (ms and launches a round), and
    each kernel's launches by name (``by_name``)."""
    from torch.autograd import DeviceType

    def ranges(name):
        return sorted((e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.name == name and e.device_type == DeviceType.CPU)

    execute = ranges("execute")[1 if skip_first else 0:]
    if not execute:
        raise AssertionError("the profile holds no execute range")
    lo, hi = execute[0][0], execute[-1][1]
    wall_us = hi - lo - sum(min(b, hi) - max(a, lo)
                            for a, b in ranges("trace_compile")
                            if a < hi and b > lo)
    # The timers' ranges also show on the device's timeline (spanning the
    # kernels launched inside them): they are not device work.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in ("execute", "trace_compile")
               and lo <= e.time_range.start <= hi]
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, min(e.time_range.end, hi))
                       for e in kernels):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    n = rounds - 1
    by_name, ms_by_name = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + 1
        ms_by_name[e.name] = (ms_by_name.get(e.name, 0.0)
                              + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"rounds_in_window": n, "wall_ms_per_round": wall_us / n / 1e3,
            "device_busy_ms_per_round": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "launches_per_round": len(kernels) / n,
            **{kind: sum(c for k, c in by_name.items()
                         if kernel_kind(k) == kind)
               for kind in ("cwfl_round", "cwfl_round_guard",
                            "ota_aggregate")},
            "top_device_ms_per_round": [[k[:100], ms / n, by_name[k] / n]
                                        for k, ms in top],
            "by_name": by_name}


def kernel_kind(name: str):
    """Which of the port's FL kernels a profiled kernel is, by its name:
    ``cwfl_round`` or ``cwfl_round_guard`` (the kernel's template
    arguments are T, C, Guard, Batched), ``ota_aggregate`` (its ring or
    its column path), else None."""
    import re

    m = re.search(r"cwfl_round_kernel<[^,]+, \d+, (true|false)", name)
    if m:
        return "cwfl_round_guard" if m.group(1) == "true" else "cwfl_round"
    if "ota_aggregate_kernel<" in name or "ota_column_kernel<" in name:
        return "ota_aggregate"
    return None


def profiled_launches(prof) -> dict:
    """Every launch of the FL kernels in a profile, by kernel."""
    from torch.autograd import DeviceType

    kinds = [kernel_kind(e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {k: kinds.count(k) for k in ("cwfl_round", "cwfl_round_guard",
                                        "ota_aggregate")}


# The trajectory phase's runs: label, scenario, rounds, the round kernel
# each round launches (unguarded, guarded), and whether it is the CIFAR
# column's CWFL-3 row of the paper phase.
TRAJECTORY_RUNS = (
    ("paper-static", "paper-static", 12, (1, 0), False),
    ("head-failure", "head-failure", 6, (0, 1), False),
    ("cluster-churn", "cluster-churn", 6, (1, 0), False),
    ("cifar/CWFL-3", None, 3, (1, 0), True),
)


def kernel_diff(loop: dict, scan: dict, n: int) -> dict:
    """The kernels (by name, launches a round) that one mode's window runs
    and the other's does not, or runs as many times: where a history that
    is not bitwise parts."""
    names = set(loop) | set(scan)
    diff = {k: (loop.get(k, 0) / n, scan.get(k, 0) / n) for k in names
            if loop.get(k, 0) != scan.get(k, 0)}
    return {k[:120]: v for k, v in sorted(diff.items(),
                                          key=lambda kv: -abs(kv[1][0]
                                                              - kv[1][1]))}


def trajectory_phase(kmod):
    """Each of TRAJECTORY_RUNS at full width, loop and scan in turns (loop,
    scan, loop, scan), then once more in each mode under
    ``torch.profiler``: the scan histories against the loop's (bitwise,
    or within the FL gate), steady rounds/s of each (loop: rounds 2..T by
    the progress callback's stamps; scan: the ``execute`` phase of
    `PhaseTimers`, rounds 2..T), and over each profiled run's rounds 2..T
    the launches a round, the device's idle share, the round kernels'
    launches counted by the profiler, and the kernels whose launches
    differ between the modes.  Returns the profiled guarded launches of
    the fault run."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TopologyConfig
    from repro_torch.obs import PhaseTimers
    from repro_torch.paper.common import BenchScale, run_setting
    from repro_torch.training import FLConfig, run_federated

    workload = full_width_workload()
    guarded = 0
    for label, scenario, rounds, (want, want_guard), cifar in TRAJECTORY_RUNS:
        def run(mode, timers=None, progress=None):
            if cifar:
                scale = dataclasses.replace(BenchScale.full(), rounds=rounds)
                return run_setting("cifar", False, "cwfl", scale,
                                   device=DEVICE, mode=mode, timers=timers,
                                   progress=progress)
            cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0,
                           seed=0)
            return run_federated(*workload, cfg, scenario=scenario,
                                 topo_cfg=TopologyConfig(num_clients=50),
                                 device=DEVICE, mode=mode, timers=timers,
                                 progress=progress)

        steady, hist = {"loop": [], "scan": []}, {}
        for mode in ("loop", "scan", "loop", "scan"):
            stamps, timers = [], PhaseTimers()
            torch.cuda.synchronize()
            h = run(mode, timers=timers if mode == "scan" else None,
                    progress=(None if mode == "scan" else
                              lambda *_: stamps.append(time.perf_counter())))
            torch.cuda.synchronize()
            if mode == "loop":
                steady["loop"].append((rounds - 1) / (stamps[-1]
                                                      - stamps[0]))
            else:
                steady["scan"].append((rounds - 1)
                                      / timers.seconds["execute"])
                steady.setdefault("scan_trace_compile_s", []).append(
                    timers.seconds["trace_compile"])
            hist.setdefault(mode, []).append(h)
            del h
        windows = {}
        for mode in ("loop", "scan"):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            kmod.launches = kmod.launches_guard = 0
            with prof:
                run(mode, timers=PhaseTimers())
                torch.cuda.synchronize()
            windows[mode] = scan_window(prof, rounds,
                                        skip_first=mode == "loop")
            calls = {"cwfl_round": kmod.launches,
                     "cwfl_round_guard": kmod.launches_guard}
        every = profiled_launches(prof)
        window = windows["scan"]
        by_name = {m: w.pop("by_name") for m, w in windows.items()}
        gap = histories_equal(hist["scan"][0], hist["loop"][0])
        line = {"phase": "trajectory", "run": label, "rounds": rounds,
                "steady_rounds_per_s_loop": steady["loop"],
                "steady_rounds_per_s_scan": steady["scan"],
                "scan_trace_compile_s": steady["scan_trace_compile_s"],
                "scan_vs_loop": gap,
                # Each mode against itself: a gap here is the kernels'
                # own run-to-run spread, not the capture's.
                "loop_vs_loop": histories_equal(*hist["loop"]),
                "scan_vs_scan": histories_equal(*hist["scan"]),
                "profiled_scan": window,
                "profiled_loop": windows["loop"],
                "kernels_that_differ": kernel_diff(
                    by_name["loop"], by_name["scan"], rounds - 1),
                # The backward kernels (cuDNN's dgrad/wgrad among them),
                # some of which may sum with atomics.
                "backward_kernels": sorted(
                    k[:120] for k in by_name["scan"]
                    if "grad" in k.lower() or "bwd" in k.lower()),
                "profiled_launches_whole_run": every,
                "wrapper_calls": calls,
                "train_loss_scan": hist["scan"][0]["train_loss"],
                "test_acc_scan": hist["scan"][0]["test_acc"]}
        emit(line)
        # One launch a round as the profiler counts them, the wrapper
        # called only for the warm-up and the captures: the replays
        # launched the rest.  (The window's own counts, on the host's
        # clock, may clip a launch at its edge and are reported only.)
        kind = "cwfl_round_guard" if want_guard else "cwfl_round"
        if not calls[kind] < every[kind]:
            raise AssertionError(f"{label}: the wrapper was called "
                                 f"{calls[kind]} times for {every[kind]} "
                                 f"launches: the scan did not replay")
        if (every["cwfl_round"], every["cwfl_round_guard"]) != (
                want * rounds, want_guard * rounds):
            raise AssertionError(f"{label}: the profiled scan run launched "
                                 f"the round kernels {every}, expected one a "
                                 f"round")
        if not fl_gate(gap):
            raise AssertionError(f"{label}: the scan history is off the "
                                 f"loop's: {gap}")
        # With cuDNN held to deterministic algorithms the CNN's run
        # replays itself: loop against loop and scan against loop.
        if cifar and not (gap["bitwise"] and line["loop_vs_loop"]["bitwise"]
                          and line["scan_vs_scan"]["bitwise"]):
            raise AssertionError(f"{label}: the CIFAR trajectory does not "
                                 f"replay itself bit for bit: {line}")
        guarded += every["cwfl_round_guard"]
    return guarded


def cudnn_flag_phase(rounds: int = 3) -> None:
    """The engine's cuDNN flags (deterministic algorithms, no autotuner)
    change nothing at MNIST width, where no convolution runs: a scanned
    paper-static run with them equals, bit for bit, the same run with
    only TF32 turned off."""
    from repro_torch.sim import engine
    from repro_torch.training import FLConfig, run_federated

    @contextlib.contextmanager
    def tf32_off_only():
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    workload = full_width_workload()
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    with_flags = run_federated(*workload, cfg, device=DEVICE)
    reference_numerics = engine._reference_numerics
    engine._reference_numerics = tf32_off_only
    try:
        without = run_federated(*workload, cfg, device=DEVICE)
    finally:
        engine._reference_numerics = reference_numerics
    gap = histories_equal(with_flags, without)
    emit({"phase": "cudnn_flags", "run": "paper-static", "rounds": rounds,
          "deterministic_vs_not": gap})
    if not gap["bitwise"]:
        raise AssertionError(f"the cuDNN flags changed an MNIST run: {gap}")


def monte_carlo_phase(kmod, omod):
    """``run_monte_carlo`` at the paper's MNIST width on the card: the
    ``snr-sweep`` grid of MC_SEEDS seeds x 5 SNRs (40 trajectories, 2,000
    stacked clients) with ``cwfl``, MC_ROUNDS rounds, as one batch; its
    trajectory-rounds/s (rounds 2..T, the ``execute`` phase) against
    trajectories run one by one in scan mode (one for each seed and each
    SNR), each of which must agree with its element of the sweep (JAX's
    tolerances, tests/test_sim_engine.py: loss rtol 2e-5, accuracy atol
    1e-2); the
    peak device memory; one profiled sweep (one launch of the batched
    round kernel a round).  Then a COTAF sweep (MC_SEEDS seeds at 40 dB)
    through the batched ``ota_aggregate``, against its lone runs; and
    ``shard="mc"`` on one NCCL rank against the unsharded sweep.  Returns
    the profiled launches of the batched kernels on the two sweeps."""
    import dataclasses
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import PhaseTimers
    from repro_torch.sim import get_scenario, run_monte_carlo, run_rounds
    from repro_torch.training import FLConfig

    workload = full_width_workload()
    launches = {}
    for strategy, scenario in (("cwfl", "snr-sweep"), ("cotaf", None)):
        cfg = FLConfig(strategy=strategy, rounds=MC_ROUNDS, num_clusters=3,
                       snr_db=40.0, seed=0)
        grid = get_scenario(scenario).snr_grid if scenario else (None,)
        B = MC_SEEDS * len(grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_at_start = torch.cuda.memory_allocated()
        timers = PhaseTimers()
        t0 = time.perf_counter()
        h = run_monte_carlo(*workload, cfg, scenario=scenario,
                            seeds=MC_SEEDS, timers=timers, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        loss = h["train_loss"].reshape(B, MC_ROUNDS)
        acc = h["test_acc"].reshape(B, MC_ROUNDS)

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        kmod.launches = omod.launches = 0
        with prof:
            again = run_monte_carlo(*workload, cfg, scenario=scenario,
                                    seeds=MC_SEEDS, timers=PhaseTimers(),
                                    device=DEVICE)
            torch.cuda.synchronize()
        window, every = scan_window(prof, MC_ROUNDS), profiled_launches(prof)
        window.pop("by_name")
        calls = {"cwfl_round": kmod.launches, "ota_aggregate": omod.launches}
        kernel = "cwfl_round" if strategy == "cwfl" else "ota_aggregate"
        launches[strategy] = every[kernel]
        repeat_equal = bool(torch.equal(again["train_loss"],
                                        h["train_loss"]))

        # One element per seed and per SNR (seed s at grid point s mod G):
        # the dynamic_sweep phase holds all 40 of its grid to their lone
        # runs, and this phase's time goes to it.
        G = len(grid)
        checked = [s * G + s % G for s in range(MC_SEEDS)]
        lone_exec, worst = 0.0, {"loss_rel": 0.0, "acc_abs": 0.0}
        for b in checked:
            s, snr = divmod(b, G)
            lone_timers = PhaseTimers()
            one = run_rounds(*workload, dataclasses.replace(
                cfg, seed=cfg.seed + s,
                snr_db=cfg.snr_db if grid[snr] is None else grid[snr]),
                mode="scan", timers=lone_timers, device=DEVICE)
            lone_exec += lone_timers.seconds["execute"]
            worst["loss_rel"] = max(worst["loss_rel"], float(
                ((one["train_loss"] - loss[b]).abs()
                 / one["train_loss"].abs()).max()))
            worst["acc_abs"] = max(worst["acc_abs"], float(
                (one["test_acc"] - acc[b]).abs().max()))
        traj_rounds = B * (MC_ROUNDS - 1)
        lone_rounds = len(checked) * (MC_ROUNDS - 1)
        line = {"phase": "monte_carlo", "strategy": strategy,
                "scenario": scenario or "paper-static", "seeds": MC_SEEDS,
                "snr_grid": list(grid), "trajectories": B,
                "stacked_clients": B * 50, "rounds": MC_ROUNDS,
                "wall_s": wall, "timers": timers.as_dict(),
                "trajectory_rounds_per_s": traj_rounds
                / timers.seconds["execute"],
                "serial_scan_trajectory_rounds_per_s": lone_rounds
                / lone_exec,
                "peak_mem_bytes": peak, "mem_at_start_bytes": mem_at_start,
                "profiled_sweep": window,
                "profiled_launches_whole_run": every,
                "wrapper_calls": calls, "elements_checked": checked,
                "vs_lone_runs": worst,
                "tol": {"loss_rel": 2e-5, "acc_abs": 1e-2},
                "repeat_bitwise": repeat_equal,
                "final_acc": h["final_acc"].tolist()}
        emit(line)
        if not (worst["loss_rel"] <= 2e-5 and worst["acc_abs"] <= 1e-2):
            raise AssertionError(f"the {strategy} sweep disagrees with its "
                                 f"lone runs: {line}")
        if every[kernel] != MC_ROUNDS or calls[kernel] != 2:
            raise AssertionError(f"the {strategy} sweep launched {kernel} "
                                 f"{every[kernel]} times in {MC_ROUNDS} "
                                 f"rounds from {calls[kernel]} wrapper calls, "
                                 f"expected one a round from the warm-up's "
                                 f"call and the capture's")
        if not all(math.isfinite(x) for x in h["train_loss"].flatten()
                   .tolist()):
            raise AssertionError(f"non-finite sweep loss: {line}")
        if strategy == "cwfl":
            sweep = h

    # shard="mc" on one NCCL rank: the whole grid is its chunk.
    cfg = FLConfig(rounds=MC_ROUNDS, num_clusters=3, snr_db=40.0, seed=0)
    store = ROOT / "build" / f"mc-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sharded = run_monte_carlo(*workload, cfg, scenario="snr-sweep",
                                  seeds=MC_SEEDS, shard="mc", device=DEVICE)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    same = (torch.equal(sharded["train_loss"], sweep["train_loss"])
            and torch.equal(sharded["test_acc"], sweep["test_acc"]))
    emit({"phase": "monte_carlo", "shard": "mc", "ranks": 1,
          "bitwise_equal_to_unsharded": bool(same),
          "loss_abs_gap": float((sharded["train_loss"]
                                 - sweep["train_loss"]).abs().max())})
    if not same:
        raise AssertionError("shard='mc' on one rank disagrees with the "
                             "unsharded sweep")
    return launches


# The dynamic sweeps at the paper's MNIST width: label, scenario (None:
# `dead_cluster_scenario` at K = 50's rates), strategy, rounds, and
# whether the seeds run over `snr-sweep`'s 5-point grid.  cluster-churn
# re-clusters at rounds 0 and 5, so its re-clustering graph is replayed
# once.  Whole clusters of some 17 members die in none of the registered
# scenarios' rounds at this width (none did on the card), so the
# dead-cluster sweep hands the batched guarded kernel its dead rows.
DYNAMIC_SWEEPS = (
    ("head-failure", "head-failure", "cwfl", 5, True),
    ("cluster-churn", "cluster-churn", "cwfl", 6, False),
    ("flaky-clients", "flaky-clients", "cwfl", 5, False),
    ("cotaf/head-failure", "head-failure", "cotaf", 5, False),
    ("dead-cluster", None, "cwfl", 5, False),
)


@contextlib.contextmanager
def dead_rows_on_device(rounds: int, batch: int):
    """While open, every launch of the round kernel from `repro_torch.core.
    cwfl` adds the dead Ã rows it is handed (Σ|row| = 0: a cluster whose
    every member is down), per trajectory, into row r of a (rounds, batch)
    count on the device, r the launch's index, which the count keeps on
    the device too.  No host sync: a captured round counts on every
    replay, as `count_dead_rows` counts a loop's syncs."""
    from repro_torch.core import cwfl

    launch = cwfl.cwfl_round
    counts = torch.zeros(rounds, batch, dtype=torch.int64, device=DEVICE)
    r = torch.zeros(1, dtype=torch.int64, device=DEVICE)

    def counting(signals, phase1, *args, **kwargs):
        dead = (phase1.abs().sum(dim=-1) <= 0).sum(dim=-1)
        counts.index_add_(0, r, dead.reshape(1, batch))
        r.add_(1)
        return launch(signals, phase1, *args, **kwargs)

    cwfl.cwfl_round = counting
    try:
        yield counts
    finally:
        cwfl.cwfl_round = launch


def dynamic_sweep_phase(kmod, omod) -> dict:
    """``run_monte_carlo`` under the dynamic scenarios of DYNAMIC_SWEEPS at
    the paper's MNIST width (K = 50, C = 3, d = 184,214), each as one
    batch: its trajectory-rounds/s (rounds 2..T, the ``execute`` phase)
    against the same trajectories run one by one in scan mode, every
    element against its lone run (bitwise; else the element is named and
    held to JAX's tolerances, loss 2e-5 relative and accuracy 1e-2), the
    peak device memory, the wrappers' calls of the FL kernels against the
    launches the profiler counts over a second run of the sweep (the
    round kernel once a round: kernel 2 batched in a fault round, kernel 1
    otherwise, kernel 3 for COTAF), and the dead Ã rows that each round
    handed the kernel, per trajectory (`dead_rows_on_device`): at least
    one over the CWFL fault sweeps.  Returns the profiled launches of the
    batched guarded kernel in the head-failure sweep."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TopologyConfig
    from repro_torch.obs import PhaseTimers
    from repro_torch.sim import get_scenario, run_monte_carlo, run_rounds
    from repro_torch.training import FLConfig

    workload = full_width_workload()
    topo_cfg = TopologyConfig(num_clients=50)
    grid5 = get_scenario("snr-sweep").snr_grid
    dead_total, guarded = 0, None
    for label, scenario, strategy, rounds, over_grid in DYNAMIC_SWEEPS:
        scenario = (get_scenario(scenario) if scenario
                    else dead_cluster_scenario(crash=0.9, recover=0.05))
        cfg = FLConfig(strategy=strategy, rounds=rounds, num_clusters=3,
                       snr_db=40.0, seed=0)
        grid = list(grid5) if over_grid else None
        G = len(grid5) if over_grid else 1
        B = MC_SEEDS * G
        sweep = lambda timers: run_monte_carlo(   # noqa: E731
            *workload, cfg, scenario=scenario, topo_cfg=topo_cfg,
            seeds=MC_SEEDS, snr_grid=grid, timers=timers, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_at_start = torch.cuda.memory_allocated()
        timers = PhaseTimers()
        with dead_rows_on_device(rounds, B) as dead:
            kmod.launches = kmod.launches_guard = omod.launches = 0
            t0 = time.perf_counter()
            h = sweep(timers)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls = {"cwfl_round": kmod.launches,
                     "cwfl_round_guard": kmod.launches_guard,
                     "ota_aggregate": omod.launches}
        peak = torch.cuda.max_memory_allocated()
        dead = dead.cpu()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            again = sweep(PhaseTimers())
            torch.cuda.synchronize()
        window, every = scan_window(prof, rounds), profiled_launches(prof)
        window.pop("by_name")
        del prof
        repeat = bool(torch.equal(again["train_loss"], h["train_loss"]))
        del again

        loss = h["train_loss"].reshape(B, rounds)
        acc = h["test_acc"].reshape(B, rounds)
        lead = 2 if grid else 1     # (S[, G], T[, C]) -> (B, T[, C])
        records = {k: v.reshape((B, rounds) + v.shape[lead + 1:])
                   for k, v in h["scenario"].items()}
        lone_exec, differ = 0.0, []
        worst = {"loss_rel": 0.0, "acc_abs": 0.0}
        for b in range(B):
            s, g = divmod(b, G)
            lone_timers = PhaseTimers()
            one = run_rounds(*workload, dataclasses.replace(
                cfg, seed=cfg.seed + s,
                snr_db=grid[g] if grid else cfg.snr_db),
                scenario=scenario, topo_cfg=topo_cfg, mode="scan",
                timers=lone_timers, device=DEVICE)
            lone_exec += lone_timers.seconds["execute"]
            same = (torch.equal(one["train_loss"], loss[b])
                    and torch.equal(one["test_acc"], acc[b])
                    and all(torch.equal(v, records[k][b])
                            for k, v in one["scenario"].items()))
            if not same:
                differ.append(b)
            worst["loss_rel"] = max(worst["loss_rel"], float(
                ((one["train_loss"] - loss[b]).abs()
                 / one["train_loss"].abs()).max()))
            worst["acc_abs"] = max(worst["acc_abs"], float(
                (one["test_acc"] - acc[b]).abs().max()))
        if strategy == "cwfl":
            kernel = ("cwfl_round" if scenario.faults.is_trivial
                      else "cwfl_round_guard")
        else:
            kernel = "ota_aggregate"
        traj_rounds = B * (rounds - 1)
        line = {"phase": "dynamic_sweep", "run": label,
                "scenario": scenario.name, "strategy": strategy,
                "seeds": MC_SEEDS, "snr_grid": grid, "trajectories": B,
                "stacked_clients": B * 50, "rounds": rounds,
                "wall_s": wall, "timers": timers.as_dict(),
                "trajectory_rounds_per_s": traj_rounds
                / timers.seconds["execute"],
                "serial_scan_trajectory_rounds_per_s": traj_rounds
                / lone_exec,
                "peak_mem_bytes": peak, "mem_at_start_bytes": mem_at_start,
                "profiled_sweep": window,
                "profiled_launches_whole_run": every,
                "wrapper_calls": calls, "kernel": kernel,
                "elements_bitwise_lone": B - len(differ),
                "elements_that_differ": differ, "vs_lone_runs": worst,
                "tol_if_not_bitwise": {"loss_rel": 2e-5, "acc_abs": 1e-2},
                "repeat_bitwise": repeat,
                "dead_rows_by_round": dead.sum(dim=1).tolist(),
                "dead_rows_total": int(dead.sum()),
                "trajectories_with_a_dead_row": int((dead.sum(0) > 0)
                                                    .sum()),
                "records_mean": {k: float(v.float().mean())
                                 for k, v in records.items()
                                 if k != "heads"},
                "final_acc_mean": float(h["final_acc"].mean()),
                "final_acc_min": float(h["final_acc"].min())}
        emit(line)
        if not (worst["loss_rel"] <= 2e-5 and worst["acc_abs"] <= 1e-2):
            raise AssertionError(f"the {label} sweep disagrees with its "
                                 f"lone runs: {line}")
        if every[kernel] != rounds or not calls[kernel] < every[kernel]:
            raise AssertionError(f"the {label} sweep launched {kernel} "
                                 f"{every[kernel]} times in {rounds} rounds "
                                 f"from {calls[kernel]} wrapper calls: "
                                 f"expected one a round, the replays "
                                 f"launching all but the warm-up's and the "
                                 f"captures'")
        others = {k: v for k, v in every.items() if k != kernel and v}
        if others:
            raise AssertionError(f"the {label} sweep launched {others} "
                                 f"beside {kernel}")
        if not all(math.isfinite(x) for x in loss.flatten().tolist()):
            raise AssertionError(f"non-finite sweep loss: {line}")
        if strategy == "cwfl" and not scenario.faults.is_trivial:
            dead_total += int(dead.sum())
        if label == "head-failure":
            guarded = every["cwfl_round_guard"]
        del h, loss, acc, records
        torch.cuda.empty_cache()
    if dead_total < 1:
        raise AssertionError("no CWFL fault sweep handed the batched "
                             "guarded kernel a dead row")
    return guarded


# The obs phase's tolerance for telemetry on the card against the CPU on the
# same draws: the ledger, the participants and the re-clustering flags
# exact; the cluster losses within the FL gate's loss 1e-4 relative; every
# other field within 1e-3 of the field's largest magnitude over the run
# (drift is a norm over d = 184,214 differences of params that the FL gate
# holds only to 1e-4 each, and the precoding and noise extras are read off
# the same params).
OBS_EXACT = ("participants", "channel_uses", "cum_channel_uses",
             "cum_symbols", "reclustered")
OBS_TOL = {"cluster_loss": 1e-4}
OBS_TOL_OTHER = 1e-3


def telemetry_fields(tele) -> dict:
    """A `RoundTelemetry` as one flat dict of tensors by field name (the
    extras under their own names)."""
    out = {k: v for k, v in tele._asdict().items() if k != "extras"}
    out.update(tele.extras)
    return out


def telemetry_bitwise(a, b) -> bool:
    fa, fb = telemetry_fields(a), telemetry_fields(b)
    return sorted(fa) == sorted(fb) and all(
        torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa)


def telemetry_gap(got, want) -> dict:
    """Each field's largest |got − want| over the field's largest
    magnitude in ``want``, and whether every field is within its
    tolerance (OBS_EXACT, OBS_TOL, OBS_TOL_OTHER)."""
    fg, fw = telemetry_fields(got), telemetry_fields(want)
    rel, ok = {}, sorted(fg) == sorted(fw)
    for k, w in fw.items():
        g, w = fg[k].float().cpu(), w.float().cpu()
        scale = max(float(w.abs().max()), 1e-30)
        rel[k] = float((g - w).abs().max()) / scale
        tol = 0.0 if k in OBS_EXACT else OBS_TOL.get(k, OBS_TOL_OTHER)
        ok = ok and rel[k] <= tol and bool(torch.isfinite(g).all())
    return {"rel": rel, "within_tol": bool(ok)}


def cifar_workload(rounds: int):
    """The CIFAR column's CWFL-3 inputs at the paper's scale (K = 27, the
    CNN, d = 698,250, non-IID), as the paper phase runs them."""
    import dataclasses

    from repro_torch.paper.common import BenchScale, make_setting

    scale = dataclasses.replace(BenchScale.full(), rounds=rounds)
    return make_setting("cifar", False, "cwfl", scale, device=DEVICE)


def obs_phase(kmod, omod) -> dict:
    """Telemetry, checkpoints and the live stream at the paper's MNIST
    width (K = 50, C = 3, d = 184,214, 40 dB), each run scanned:

    1. paper-static, 12 rounds, telemetry off and on: the loss, accuracy
       and final params bitwise; steady rounds/s of each; then 4 rounds
       with the same draws (made on the CPU) on the card and on the CPU,
       the card's telemetry within the gate of OBS_TOL;
    2. the same 12 rounds with a `MemorySink` stream: every record bitwise
       the post-hoc telemetry (the tap runs with host syncs raising);
    3. paper-static and head-failure (kernel 2), 12 rounds, a checkpoint
       every 4, stopped after round 5 (at 8), resumed: history, telemetry
       and final params bitwise the uninterrupted run; each save's ms and
       one step directory's bytes;
    4. the head-failure 8 seeds × 5 SNRs sweep with telemetry, 5 rounds:
       trajectory-rounds/s, peak memory, each element's telemetry bitwise
       its lone telemetered run;
    5. CIFAR CWFL-3 with telemetry, 3 rounds: rounds/s, peak memory;
    6. one NCCL rank, client-sharded, 6 rounds with telemetry: the scan
       bitwise its loop, and a resume (a checkpoint every 2, stopped after
       round 3) bitwise the scan;
    and COTAF and decentralized (kernel 3) with telemetry, 5 rounds.
    Returns each kernel's wrapper calls on these paths."""
    import dataclasses
    import datetime
    import shutil

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TopologyConfig
    from repro_torch.obs import MemorySink, PhaseTimers, RoundStream
    from repro_torch.obs.stream import _np_tree, _tree_index
    from repro_torch.sim import TorchDraws, get_scenario, run_monte_carlo
    from repro_torch.sim import run_rounds
    from repro_torch.training import FLConfig

    t_phase = time.perf_counter()
    workload = full_width_workload()
    topo_cfg = TopologyConfig(num_clients=50)
    cfg = FLConfig(rounds=12, num_clusters=3, snr_db=40.0, seed=0)
    ckpt_root = ROOT / "build" / f"obs-ckpt-{os.getpid()}"
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def run(c=cfg, **kw):
        return run_rounds(*workload, c, topo_cfg=topo_cfg, device=DEVICE,
                          **kw)

    def calls():
        return {"cwfl_round": kmod.launches,
                "cwfl_round_guard": kmod.launches_guard,
                "ota_aggregate": omod.launches}

    def zero():
        kmod.launches = kmod.launches_guard = omod.launches = 0

    def steady(timers, rounds):
        return (rounds - 1) / timers.seconds["execute"]

    wrapper = {}
    out = {"phase": "obs", "K": 50, "C": 3, "d": 184214}

    # 1. Telemetry off and on.
    hist, rate = {}, {}
    for label, kw in (("off", {}), ("on", {"telemetry": True}),
                      ("off_again", {}), ("on_again", {"telemetry": True})):
        timers = PhaseTimers()
        torch.cuda.synchronize()
        zero()
        hist[label] = run(timers=timers, **kw)
        torch.cuda.synchronize()
        rate[label] = steady(timers, cfg.rounds)
        if label == "on":
            wrapper["paper_static_telemetry"] = calls()
    on = hist["on"]
    off_vs_on = histories_equal(on, hist["off"])
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        run(telemetry=True)
        torch.cuda.synchronize()
    profiled = profiled_launches(prof)
    del prof
    c4 = dataclasses.replace(cfg, rounds=4)
    card = run(c4, telemetry=True, draws=TorchDraws(0, "cpu"))
    cpu = run_rounds(*workload, c4, topo_cfg=topo_cfg, device="cpu",
                     telemetry=True, draws=TorchDraws(0, "cpu"))
    card_vs_cpu = {"history": histories_equal(card, cpu),
                   "telemetry": telemetry_gap(card["telemetry"],
                                              cpu["telemetry"])}
    del card, cpu
    out["telemetry"] = {
        "rounds": cfg.rounds,
        "steady_rounds_per_s_off": [rate["off"], rate["off_again"]],
        "steady_rounds_per_s_on": [rate["on"], rate["on_again"]],
        "on_vs_off": off_vs_on,
        "on_vs_on_again_telemetry_bitwise": telemetry_bitwise(
            on["telemetry"], hist["on_again"]["telemetry"]),
        "profiled_launches_12_rounds": profiled,
        "card_vs_cpu_4_rounds": card_vs_cpu,
        "tol": {"exact": list(OBS_EXACT), **OBS_TOL,
                "other_rel_to_scale": OBS_TOL_OTHER},
        "cum_channel_uses_last": float(on["telemetry"].cum_channel_uses[-1]),
        "cum_symbols_last": float(on["telemetry"].cum_symbols[-1]),
        "cluster_loss_last": on["telemetry"].cluster_loss[-1].tolist(),
        "power_budget_frac_last": float(
            on["telemetry"].extras["power_budget_frac"][-1])}
    if not off_vs_on["bitwise"]:
        raise AssertionError(f"telemetry changed the run: {off_vs_on}")
    if profiled != {"cwfl_round": cfg.rounds, "cwfl_round_guard": 0,
                    "ota_aggregate": 0}:
        raise AssertionError(f"the telemetered paper-static run launched "
                             f"{profiled} in {cfg.rounds} rounds")
    if not card_vs_cpu["telemetry"]["within_tol"] or not fl_gate(
            card_vs_cpu["history"]):
        raise AssertionError(f"the card's telemetry is off the CPU's: "
                             f"{card_vs_cpu}")

    # 2. The live stream.
    sink = MemorySink()
    stream = RoundStream([sink])
    timers = PhaseTimers()
    torch.cuda.synchronize()
    streamed = run(telemetry=True, stream=stream, timers=timers)
    torch.cuda.synchronize()
    tele = _np_tree(streamed["telemetry"])
    records = stream.records()
    same = (histories_equal(streamed, on)["bitwise"]
            and [r["round"] for r in records] == list(
                range(1, cfg.rounds + 1))
            and all(np.array_equal(r["train_loss"],
                                   streamed["train_loss"][r["round"] - 1]
                                   .cpu().numpy())
                    and stream_record_equal(r["telemetry"], _tree_index(
                        tele, r["round"] - 1)) for r in records))
    out["stream"] = {"records": len(records), "errors": stream.errors,
                     "records_bitwise_posthoc": bool(same),
                     "host_syncs_raise_in_tap": True,
                     "steady_rounds_per_s": steady(timers, cfg.rounds)}
    if not same or stream.errors:
        raise AssertionError(f"the stream is not the telemetry: {out}")
    del streamed, records, tele

    # 3. Checkpoint and resume.
    zero()
    out["resume"] = {}
    for label, scenario in (("paper-static", None),
                            ("head-failure", "head-failure")):
        full = on if scenario is None else run(scenario=scenario,
                                               telemetry=True)
        where = ckpt_root / label
        part = run(scenario=scenario, telemetry=True, checkpoint_dir=where,
                   checkpoint_every=4, stop_after=5)
        res = run(scenario=scenario, telemetry=True, checkpoint_dir=where,
                  checkpoint_every=4, resume=True)
        torch.cuda.synchronize()
        gap = histories_equal(res, full)
        line = {"rounds_before_stop": int(part["train_loss"].shape[0]),
                "resumed_from": res["checkpoint"]["resumed_from"],
                "history": gap,
                "telemetry_bitwise": telemetry_bitwise(res["telemetry"],
                                                       full["telemetry"]),
                "save_ms": [s * 1e3 for _, s in
                            part["checkpoint"]["saves"]
                            + res["checkpoint"]["saves"]],
                "step_dir_bytes": sum(
                    f.stat().st_size for f in
                    (where / "step_00000004").iterdir())}
        out["resume"][label] = line
        if not (gap["bitwise"] and line["telemetry_bitwise"]
                and line["rounds_before_stop"] == 8
                and line["resumed_from"] == 8):
            raise AssertionError(f"{label}: the resumed run is not the "
                                 f"uninterrupted one: {line}")
        del full, part, res
    wrapper["resume_both"] = calls()
    if not wrapper["resume_both"]["cwfl_round_guard"]:
        raise AssertionError("the head-failure runs never called the "
                             "guarded kernel")
    del on, hist

    # 4. The head-failure sweep with telemetry.
    grid = list(get_scenario("snr-sweep").snr_grid)
    c5 = dataclasses.replace(cfg, rounds=5)
    B = MC_SEEDS * len(grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    timers = PhaseTimers()
    zero()
    h = run_monte_carlo(*workload, c5, scenario="head-failure",
                        topo_cfg=topo_cfg, seeds=MC_SEEDS, snr_grid=grid,
                        timers=timers, device=DEVICE, telemetry=True)
    torch.cuda.synchronize()
    wrapper["head_failure_sweep"] = calls()
    peak = torch.cuda.max_memory_allocated()
    differ, fields = [], {}
    for b in range(B):
        s, g = divmod(b, len(grid))
        one = run(dataclasses.replace(c5, seed=c5.seed + s, snr_db=grid[g]),
                  scenario="head-failure", telemetry=True)
        elem = nest_index(h["telemetry"], (s, g))
        if not (telemetry_bitwise(one["telemetry"], elem)
                and torch.equal(one["train_loss"], h["train_loss"][s, g])):
            differ.append(b)
            if len(fields) < 3:
                fa, fb = telemetry_fields(one["telemetry"]), \
                    telemetry_fields(elem)
                fields[b] = sorted(k for k in fa if not torch.equal(
                    fa[k], fb[k]))
    out["sweep"] = {
        "scenario": "head-failure", "trajectories": B, "rounds": c5.rounds,
        "trajectory_rounds_per_s": B * (c5.rounds - 1)
        / timers.seconds["execute"], "timers": timers.as_dict(),
        "peak_mem_bytes": peak, "mem_at_start_bytes": at_start,
        "elements_bitwise_lone": B - len(differ),
        "elements_that_differ": differ, "fields_that_differ": fields,
        "telemetry_shape_cluster_loss": list(h["telemetry"].cluster_loss
                                             .shape)}
    if differ:
        raise AssertionError(f"sweep elements off their lone runs: {out}")
    del h
    torch.cuda.empty_cache()

    # COTAF and decentralized (kernel 3, whose W their extras read).
    out["baselines"] = {}
    for strategy in ("cotaf", "decentralized"):
        zero()
        hb = run(dataclasses.replace(cfg, strategy=strategy, rounds=5),
                 telemetry=True)
        torch.cuda.synchronize()
        wrapper[strategy] = calls()
        fields = telemetry_fields(hb["telemetry"])
        out["baselines"][strategy] = {
            "finite": all(bool(torch.isfinite(v).all())
                          for v in fields.values()),
            "channel_uses": hb["telemetry"].channel_uses.tolist(),
            "extras": sorted(hb["telemetry"].extras)}
        if not out["baselines"][strategy]["finite"] or not (
                wrapper[strategy]["ota_aggregate"]):
            raise AssertionError(f"{strategy} with telemetry: {out}")
        del hb

    # 5. CIFAR CWFL-3 with telemetry.
    cifar, ccfg = cifar_workload(rounds=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers = PhaseTimers()
    zero()
    hc = run_rounds(*cifar, ccfg, device=DEVICE, telemetry=True,
                    timers=timers)
    torch.cuda.synchronize()
    wrapper["cifar"] = calls()
    out["cifar"] = {
        "rounds": ccfg.rounds,
        "steady_rounds_per_s": steady(timers, ccfg.rounds),
        "timers": timers.as_dict(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "telemetry_forward": "all 27 clients' shards at once (unchunked)",
        "cluster_loss_last": hc["telemetry"].cluster_loss[-1].tolist(),
        "test_acc": hc["test_acc"].tolist()}
    if not all(bool(torch.isfinite(v).all()) for v in
               telemetry_fields(hc["telemetry"]).values()):
        raise AssertionError(f"non-finite CIFAR telemetry: {out['cifar']}")
    del cifar, hc
    torch.cuda.empty_cache()

    # 6. One NCCL rank, client-sharded.
    c6 = dataclasses.replace(cfg, rounds=6)
    store = ROOT / "build" / f"obs-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        kw = dict(device=DEVICE, shard="clients", telemetry=True)
        loop = run_rounds(*workload, c6, mode="loop", **kw)
        scan = run_rounds(*workload, c6, **kw)
        where = ckpt_root / "clients"
        run_rounds(*workload, c6, checkpoint_dir=where, checkpoint_every=2,
                   stop_after=3, **kw)
        res = run_rounds(*workload, c6, checkpoint_dir=where,
                         checkpoint_every=2, resume=True, **kw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    out["clients"] = {
        "ranks": 1, "rounds": c6.rounds,
        "scan_vs_loop": histories_equal(scan, loop),
        "scan_vs_loop_telemetry_bitwise": telemetry_bitwise(
            scan["telemetry"], loop["telemetry"]),
        "resume_vs_scan": histories_equal(res, scan),
        "resume_telemetry_bitwise": telemetry_bitwise(res["telemetry"],
                                                      scan["telemetry"])}
    shutil.rmtree(ckpt_root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["wrapper_calls"] = wrapper
    emit(out)
    c = out["clients"]
    if not (c["scan_vs_loop"]["bitwise"]
            and c["scan_vs_loop_telemetry_bitwise"]
            and c["resume_vs_scan"]["bitwise"]
            and c["resume_telemetry_bitwise"]):
        raise AssertionError(f"the client-sharded run with telemetry and "
                             f"resume is not bitwise: {c}")
    for label, counts in wrapper.items():
        if not any(counts.values()):
            raise AssertionError(f"{label}: no kernel was called: {counts}")
    return wrapper


def nest_index(obj, idx):
    """A nest with every tensor indexed by ``idx``."""
    from repro_torch.utils.nest import nest_map

    return nest_map(lambda x: x[idx], obj)


def stream_record_equal(a, b) -> bool:
    """Two streamed telemetry records (nested dicts of numpy arrays) bit
    for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(stream_record_equal(a[k], b[k]) for k in a))
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


# ---------------------------------------------------------------------------
# LM training: the attention backward, the train steps, Qwen2.5-3B.
# ---------------------------------------------------------------------------

BWD_SHAPES = (
    # label, B, H, KV, S, D, dtype, window, cap[, options: ``causal``
    # (default True), ``skv`` (keys, default S), ``pad`` (the head dim
    # zero-padded to the kernels' next, `kernels.ops.pad_head_dim`, and
    # the gradients sliced back, as the model's op runs Kimi K2's 112)]
    ("qwen", 1, 16, 2, 4096, 128, torch.float32, 0, 0.0),
    ("qwen_bf16", 1, 16, 2, 4096, 128, torch.bfloat16, 0, 0.0),
    ("gemma2_global", 2, 16, 8, 4608, 256, torch.float32, 0, 50.0),
    ("gemma2_local", 2, 16, 8, 4608, 256, torch.float32, 4096, 50.0),
    ("gemma2_global_bf16", 2, 16, 8, 4608, 256, torch.bfloat16, 0, 50.0),
    ("gemma2_local_bf16", 2, 16, 8, 4608, 256, torch.bfloat16, 4096, 50.0),
    ("ragged_gqa", 1, 16, 2, 1000, 128, torch.float32, 0, 0.0),
    ("ragged_gqa_bf16", 1, 16, 2, 1000, 128, torch.bfloat16, 0, 0.0),
) + tuple((f"small_d{D}_{str(dt)[6:]}", 2, 6, 2, 130, D, dt, 40, 50.0)
          for D in (32, 64, 128, 256)
          for dt in (torch.float32, torch.bfloat16)) + (
    # The training geometries of the other mixers, front ends and dense
    # models (`TRAIN_RUNS`, bf16 as they train): G = 16; D = 112 through
    # the pad; Jamba's and InternVL2's layers (the VLM's 256 patch
    # positions and 3,840 tokens); whisper's encoder (no mask)
    # and its cross-attention (4,096 queries on 1,500 frames); phi4-mini.
    ("qwen3_moe_bf16", 1, 64, 4, 4096, 128, torch.bfloat16, 0, 0.0),
    ("kimi_k2_d112_bf16", 1, 64, 8, 4096, 112, torch.bfloat16, 0, 0.0,
     {"pad": True}),
    ("jamba_bf16", 1, 32, 8, 4096, 128, torch.bfloat16, 0, 0.0),
    ("internvl2_bf16", 2, 16, 8, 4096, 128, torch.bfloat16, 0, 0.0),
    ("whisper_encoder_bf16", 2, 6, 6, 1500, 64, torch.bfloat16, 0, 0.0,
     {"causal": False}),
    ("whisper_cross_bf16", 2, 6, 6, 4096, 64, torch.bfloat16, 0, 0.0,
     {"causal": False, "skv": 1500}),
    ("phi4_mini_bf16", 2, 24, 8, 4096, 128, torch.bfloat16, 0, 0.0),
)
# Each gradient's largest error over its largest magnitude, against the
# plain backward on the same o and lse: f32 sums in another order; bf16
# outputs (one rounding, 2^-8 of the value, plus the sums').
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# The forward's row statistics against the plain version's (absolute: the
# kernels take exp as ex2.approx, about 2 ulp).
LSE_TOL = 1e-3


def sdpa_backward(q, k, v, do, is_causal: bool = True,
                  scale: float | None = None):
    """The library yardstick at cap 0: ``scaled_dot_product_attention``
    (``enable_gqa``) and ``torch.autograd.grad`` through it, and its
    forward alone; never on the port's path."""
    import torch.nn.functional as F

    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def forward():
        return F.scaled_dot_product_attention(qg, kg, vg,
                                              is_causal=is_causal,
                                              enable_gqa=True, scale=scale)

    def both():
        return torch.autograd.grad(forward(), (qg, kg, vg), do)

    return forward, both


def fa_bwd_kernel_phase(fa, ref_fn, bwd_ref_fn, shapes=BWD_SHAPES) -> list:
    """The attention backward kernel against its plain version at
    BWD_SHAPES: the forward kernel run with its row statistics (lse,
    against the plain forward's; o bitwise the serve path's, which
    writes no lse), then ``flash_attention_bwd`` on that o and lse, every
    output poisoned with NaN, against ``flash_attention_bwd_ref`` on the
    same inputs, a second launch bitwise the first.  At the full-width
    shapes: device ms against the bounds (five products of 2·D
    operations a kept pair: on the CUDA cores at the f32 rate, and on the
    tensor cores, as three TF32 passes in f32, in one bf16 pass; the time
    must lie above the larger of the tensor-core and the bytes bound),
    the plain version's ms, the forward kernel's ms with lse and, at cap
    0, SDPA's backward (its forward and backward less its forward).  Then
    a line with the workspace the backward allocates at Qwen2.5-3B's
    shape.  Returns the kernels-summary rows of the f32 and bf16 backward
    at that shape (none when ``shapes`` leaves it out), with the other
    full-width rows' times under ``geometries``."""
    from repro_torch.kernels.ops import pad_head_dim
    from repro_torch.launch.roofline import unmasked_pairs

    bw, peak_f32, peak_bf16, peak_tf32 = card_peaks(
        torch.cuda.get_device_name(0))
    rows = {}
    for label, B, H, KV, S, D, dtype, window, cap, *opt in shapes:
        opt = opt[0] if opt else {}
        causal, Skv = opt.get("causal", True), opt.get("skv", S)
        g = torch.Generator(DEVICE).manual_seed(S + D + window + 1)
        q = (4 * torch.randn(B, H, S, D, generator=g, device=DEVICE)).to(
            dtype)
        k = torch.randn(B, KV, Skv, D, generator=g, device=DEVICE).to(dtype)
        v = torch.randn(B, KV, Skv, D, generator=g, device=DEVICE).to(dtype)
        do = torch.randn(B, H, S, D, generator=g, device=DEVICE).to(dtype)
        mode = {"causal": causal, "window": window, "cap": cap,
                "scale": D ** -0.5}
        args = (causal, window, cap, mode["scale"])
        # The kernels' operands: the head dim padded where the row says
        # so (the model's op pads Kimi K2's 112 to 128), the gradients
        # sliced back to D.
        kq, kk, kv_, kdo = ((pad_head_dim(x) for x in (q, k, v, do))
                            if opt.get("pad") else (q, k, v, do))

        def kernel_bwd(o, lse):
            return tuple(x[..., :D].contiguous() if opt.get("pad") else x
                         for x in fa.flash_attention_bwd(
                             kq, kk, kv_, o, lse, kdo, **mode))

        o, lse = poisoned_outputs(fa, lambda: fa._forward(kq, kk, kv_,
                                                          *args, True))
        o_serve = fa._forward(kq, kk, kv_, *args, False)[0]
        ref_o, ref_lse = ref_fn(q, k, v, return_lse=True, **mode)
        lse_err = float((lse - ref_lse).abs().max())
        grads = poisoned_outputs(fa, lambda: kernel_bwd(o, lse))
        again = kernel_bwd(o, lse)
        o_model = o[..., :D] if opt.get("pad") else o
        want = bwd_ref_fn(q, k, v, o_model, lse, do, **mode)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b)
                for n, a, b in zip(("dq", "dk", "dv"), grads, want)}
        abs_errs = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(("dq", "dk", "dv"), grads, want)}
        tol = BWD_TOL[dtype]
        line = {"phase": "lm_train", "kernel": "flash_attention_bwd",
                "shape": label, "B": B, "H": H, "KV": KV, "S": S, "D": D,
                "Skv": Skv, "causal": causal, "padded_to": kq.shape[-1],
                "dtype": str(dtype), "window": window, "cap": cap,
                "design": bwd_design(fa, dtype, kq.shape[-1]),
                "rel_err": errs, "tol_rel": tol, "abs_err": abs_errs,
                "lse_abs_err": lse_err,
                "tol_lse": LSE_TOL,
                "o_bitwise_serve": bool(torch.equal(o, o_serve)),
                "o_abs_err": float((o_model.float()
                                    - ref_o.float()).abs().max()),
                "bitwise_rerun": all(torch.equal(a, b)
                                     for a, b in zip(grads, again)),
                "finite": all(bool(torch.isfinite(x.float()).all())
                              for x in grads)}
        del ref_o, ref_lse, want, again
        if not label.startswith("small"):
            pairs = B * H * unmasked_pairs(S, window, causal, Skv)
            flops = 5 * 2 * D * pairs
            nbytes = ((3 * q.numel() + 4 * k.numel()) * q.element_size()
                      + 4 * lse.numel())
            tc = (flops / peak_bf16 if dtype == torch.bfloat16
                  else 3 * flops / peak_tf32) * 1e3
            reps = 5 if S >= 4096 else 20
            ms = device_ms(lambda: fa.flash_attention_bwd(
                kq, kk, kv_, o, lse, kdo, **mode), reps)
            plain_ms = device_ms(lambda: bwd_ref_fn(q, k, v, o_model, lse,
                                                    do, **mode), 3)
            # The forward kernel as training runs it (with lse), beside
            # the library's forward below.
            line["fwd_ms"] = device_ms(lambda: fa._forward(
                kq, kk, kv_, *args, True), reps)
            line.update(ms=ms, plain_ms=plain_ms, flops=flops, bytes=nbytes,
                        bound_ms_bytes=nbytes / bw * 1e3,
                        bound_ms_cuda_cores=flops / peak_f32 * 1e3,
                        bound_ms_tensor_cores=tc,
                        achieved_flops_per_s=flops / (ms * 1e-3),
                        library_ms=None)
            if cap == 0.0 and window == 0:
                forward, both = sdpa_backward(q, k, v, do, causal)
                lib = both()
                want = bwd_ref_fn(q, k, v, o_model, lse, do, **mode)
                line["library"] = "scaled_dot_product_attention backward"
                line["library_rel_err"] = {
                    n: rel_err(a, b)
                    for n, a, b in zip(("dq", "dk", "dv"), lib, want)}
                del lib, want
                line["library_fwd_bwd_ms"] = device_ms(both, reps)
                line["library_fwd_ms"] = device_ms(forward, reps)
                line["library_ms"] = (line["library_fwd_bwd_ms"]
                                      - line["library_fwd_ms"])
            rows[label] = line
            above_bound(f"flash_attention_bwd at {label}", {"ms": ms},
                        max(line["bound_ms_bytes"], tc))
        emit(line)
        if not (all(e <= tol for e in errs.values()) and line["finite"]
                and lse_err <= LSE_TOL and line["o_bitwise_serve"]
                and line["bitwise_rerun"]):
            raise AssertionError(f"the attention backward disagrees with "
                                 f"its plain version at {label}: {line}")
        del q, k, v, do, o, lse, o_serve, grads, kq, kk, kv_, kdo, o_model
        torch.cuda.empty_cache()
    if "qwen" not in rows:
        return []
    B, H, KV, S, D = BWD_SHAPES[0][1:6]
    emit({"phase": "lm_train", "kernel": "flash_attention_bwd",
          "workspace_bytes": {
              str(dt): 4 * fa.bwd_workspace_floats(B, H, KV, S, S, D, dt)
              for dt in (torch.float32, torch.bfloat16)},
          "shape": BWD_SHAPES[0][0], "B": B, "H": H, "KV": KV, "S": S,
          "D": D})
    out = []
    for name, label in (("flash_attention_bwd", "qwen"),
                        ("flash_attention_bwd_bf16", "qwen_bf16")):
        main = rows[label]
        bound = max(main["bound_ms_bytes"], main["bound_ms_tensor_cores"])
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:28 (its "
                        "gradient, which JAX takes through "
                        "src/repro/models/attention.py:32)",
            "launches": None, "max_abs_err": max(main["abs_err"].values()),
            "max_rel_err": max(main["rel_err"].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": bound,
            "bound_by": ("bytes" if main["bound_ms_bytes"] >= bound
                         else "operations"),
            "bound_basis": ("3xTF32 on the tensor cores (f32 accuracy)"
                            if name == "flash_attention_bwd" else
                            "bf16 on the tensor cores"),
            "bound_ms_f32_cuda_cores": main["bound_ms_cuda_cores"],
            "library_ms": main["library_ms"], "library": main["library"],
            "design": main["design"], "shape": label,
            "geometries": {
                other: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": max(r["bound_ms_bytes"],
                                        r["bound_ms_tensor_cores"]),
                        "library_ms": r["library_ms"],
                        "max_rel_err": max(r["rel_err"].values()),
                        "B": r["B"], "H": r["H"], "KV": r["KV"],
                        "S": r["S"], "Skv": r["Skv"], "D": r["D"],
                        "causal": r["causal"]}
                for other, r in rows.items()
                if r["dtype"] == main["dtype"] and other != label}})
    return out


def bwd_design(fa, dtype, D: int) -> str:
    """The design of the attention backward that runs at ``dtype`` and
    head dim ``D``."""
    if dtype == torch.float32:
        kv = ("3xTF32 wgmma over the split pass's TF32 halves; dK/dV a "
              "block per (64-key tile, KV head, query head), one consumer "
              "warpgroup on S^T, P^T, dV and one on dP^T, dS^T, dK")
        dq = "dQ a block per 64-query tile"
        if D == 256:
            kv += ", K and V lo streamed with the q and dO chunks"
            dq += ", 32-key tiles, q and dO lo streamed with K and V"
    elif D < 256:
        kv = ("bf16 wgmma, P and dS rounded to bf16 in registers; dK/dV a "
              "block per (128-key tile, KV head, query head), two consumer "
              "warpgroups of 64 keys in turns")
        dq = ("dQ a block per 128-query tile, S and dP issued with the "
              "last tile's dQ product")
    else:
        kv = ("bf16 wgmma, P and dS rounded to bf16 in registers; dK/dV a "
              "block per (64-key tile, KV head, query head), one consumer "
              "warpgroup on S^T, P^T, dV and one on dP^T, dS^T, dK")
        dq = "dQ a block per 64-query tile"
    return (f"{kv}; {dq}; TMA loads from a producer thread; a delta "
            "pre-pass; the G partials of dK and dV summed in a fixed "
            "order, no atomics")


# The reduced Gemma-2's train steps on the card against the CPU: relative
# to each leaf's largest magnitude, f32 sums in other orders (cuBLAS and
# the kernels against ATen's CPU loops and the plain versions); bf16: one
# bf16 ulp (2^-8) of a parameter or of the loss may flip.
LM_REF_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LM_REF_S, LM_REF_B = 64, 4


def tree_rel_err(got, want) -> float:
    """The largest over leaves of max |got − want| / max |want|."""
    from repro_torch.utils import tree_leaves

    return max(rel_err(a, b) if b.abs().max() > 0 else
               float((a.float().cpu() - b.float().cpu()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def lm_train_reference_phase(fa, kmod) -> dict:
    """The reduced Gemma-2 (``get_config("gemma2-9b", reduced=True)``)
    trained on the card and on the CPU from the same params, tokens and
    noise: two shard-mode steps (M = 2, the plan's weights and channel
    noise), two replica steps (K = 4, C = 2, two local steps a client;
    ``cwfl_round`` once a step), one bf16 shard step; the losses and
    params within LM_REF_TOL, and each kernel's launches on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.fl_integration import make_fl_plan
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import InputShape
    from repro_torch.optim import sgd
    from repro_torch.training import dist_steps as ds
    from repro_torch.utils import tree_leaves, tree_map
    from repro_torch.utils.nest import nest_stack

    cfg = get_config("gemma2-9b", reduced=True)
    shape = InputShape("train", LM_REF_S, LM_REF_B, "train")
    plan_cpu = make_fl_plan(4, 2, 0, device="cpu")
    plan_card = dataclasses.replace(plan_cpu,
                                    state=state_to(plan_cpu.state, DEVICE))
    g = torch.Generator().manual_seed(0)
    seqs = torch.randint(0, cfg.vocab_size, (2, LM_REF_B, LM_REF_S + 1),
                         generator=g)
    batches = [{"tokens": x[:, :-1], "labels": x[:, 1:]} for x in seqs]

    def card(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(a.to(DEVICE) for a in tree)
        return tree_map(lambda a: a.to(DEVICE), tree)

    def counts():
        return {n: getattr(fa, n) for n in (
            "launches", "launches_bf16", "launches_bwd",
            "launches_bwd_bf16")} | {"cwfl_round": kmod.launches}

    def zero():
        fa.launches = fa.launches_bf16 = 0
        fa.launches_bwd = fa.launches_bwd_bf16 = 0
        kmod.launches = 0

    def shard(run_cfg, steps, M, device):
        params = tfm.init_params(0, run_cfg, device="cpu")
        noise_g = torch.Generator().manual_seed(1)
        fn = ds.make_train_step(run_cfg, shape, plan=plan_cpu, lr=0.05,
                                microbatches=M)
        state = sgd(0.05).init(params)
        params = card(params) if device == DEVICE else params
        losses = []
        for step in range(steps):
            noise = [torch.randn(x.shape, generator=noise_g)
                     for x in tree_leaves(params)]
            batch = batches[step]
            if device == DEVICE:
                noise, batch = card(noise), card(batch)
            params, state, m = fn(params, state, batch, noise)
            losses.append(m["loss"])
        return params, torch.stack(losses)

    def replica(steps, device):
        K = plan_cpu.num_clients
        stacked = nest_stack([tfm.init_params(k, cfg, device="cpu")
                              for k in range(K)])
        fn = ds.make_replica_train_step(
            cfg, shape, plan_card if device == DEVICE else plan_cpu,
            lr=0.05, local_steps=2)
        noise_g = torch.Generator().manual_seed(2)
        d = sum(x[0].numel() for x in tree_leaves(stacked))
        stacked = card(stacked) if device == DEVICE else stacked
        losses = []
        for step in range(steps):
            noise = tuple(torch.randn((plan_cpu.num_clusters, d),
                                      generator=noise_g) for _ in range(2))
            batch = {k: x.reshape((K, LM_REF_B // K) + x.shape[1:])
                     for k, x in batches[step].items()}
            if device == DEVICE:
                noise, batch = card(noise), card(batch)
            stacked, loss = fn(stacked, batch, noise)
            losses.append(loss)
        return stacked, torch.stack(losses)

    bf16_cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    runs = (("shard_f32", lambda dev: shard(cfg, 2, 2, dev),
             torch.float32),
            ("replica_f32", lambda dev: replica(2, dev), torch.float32),
            ("shard_bf16", lambda dev: shard(bf16_cfg, 1, 2, dev),
             torch.bfloat16))
    out = {}
    for label, run, dtype in runs:
        want_p, want_l = run("cpu")
        zero()
        got_p, got_l = run(DEVICE)
        torch.cuda.synchronize()
        launched = counts()
        line = {"phase": "lm_train", "run": f"gemma2-reduced-{label}",
                "loss_cuda": got_l.tolist(), "loss_cpu": want_l.tolist(),
                "loss_rel_err": rel_err(got_l, want_l),
                "params_rel_err": tree_rel_err(got_p, want_p),
                "tol_rel": LM_REF_TOL[dtype], "launches": launched,
                "layers": cfg.num_layers}
        emit(line)
        if not (line["loss_rel_err"] <= LM_REF_TOL[dtype]
                and line["params_rel_err"] <= LM_REF_TOL[dtype]):
            raise AssertionError(f"the reduced Gemma-2's {label} steps on "
                                 f"the card disagree with the CPU: {line}")
        out[label] = launched
    L = cfg.num_layers
    want = {"shard_f32": {"launches": 2 * 2 * L, "launches_bwd": 2 * 2 * L},
            "replica_f32": {"launches": 2 * 4 * 2 * L,
                            "launches_bwd": 2 * 4 * 2 * L, "cwfl_round": 2},
            "shard_bf16": {"launches_bf16": 2 * L,
                           "launches_bwd_bf16": 2 * L}}
    for label, expected in want.items():
        full = {n: 0 for n in out[label]} | expected
        if out[label] != full:
            raise AssertionError(f"{label}: the kernels launched "
                                 f"{out[label]} times, expected {full}")
    return out


# Qwen2.5-3B's training at its published width and depth: JAX's train_4k
# shape with the global batch cut from 256 to 4 sequences of 4,096 tokens
# (auto_microbatches: M = 4, one sequence a microbatch), f32, the shard-mode
# step with a K = 4, C = 3, 40 dB plan at JAX's default lr.
QWEN_BATCH, QWEN_SEQ, QWEN_LR = 4, 4096, 1e-3
QWEN_CE0_TOL = 0.5    # the first CE within this of ln V (near-uniform logits)


def lm_qwen_phase(fa) -> dict:
    """Three shard-mode steps of Qwen2.5-3B at full width on the card:
    step 1 and step 2 on one batch (the second CE below the first), step 3
    on another, under the profiler.  Seconds a step, tokens/s, peak
    memory, each kernel's launches a step (36 x M forward and backward),
    and the device time of the attention backward, of the forward
    attention and of the matrix products in the profiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_dataset
    from repro_torch.dist.fl_integration import make_fl_plan
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import InputShape
    from repro_torch.optim import sgd
    from repro_torch.training import dist_steps as ds

    cfg = get_config("qwen2.5-3b")
    shape = InputShape("train_4k", QWEN_SEQ, QWEN_BATCH, "train")
    M = ds.auto_microbatches(cfg, shape)
    gc.collect()   # cycles left by earlier phases may hold device memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = make_fl_plan(4, 3, 0, snr_db=40.0, device=DEVICE)
    params = tfm.init_params(0, cfg, device=DEVICE)
    seqs = make_token_dataset(1, cfg.vocab_size, 2 * QWEN_BATCH, QWEN_SEQ,
                              device=DEVICE)
    batches = [{"tokens": x[:, :-1], "labels": x[:, 1:]}
               for x in seqs.split(QWEN_BATCH)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fn = ds.make_train_step(cfg, shape, plan=plan, lr=QWEN_LR)
    state = sgd(QWEN_LR).init(params)
    noise = torch.Generator(DEVICE).manual_seed(3)
    steps = []
    for i, batch in enumerate((batches[0], batches[0], batches[1])):
        fa.launches = fa.launches_bwd = 0
        fa.launches_bf16 = fa.launches_bwd_bf16 = 0
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if i == 2 else contextlib.nullcontext())
        torch.cuda.synchronize()
        with prof:
            t0 = time.perf_counter()
            params, state, m = fn(params, state, batch, noise)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        steps.append({"s": seconds, "ce": float(m["ce"]),
                      "loss": float(m["loss"]),
                      "launches": fa.launches,
                      "launches_bwd": fa.launches_bwd,
                      "launches_bf16": fa.launches_bf16,
                      "launches_bwd_bf16": fa.launches_bwd_bf16})
    peak = torch.cuda.max_memory_allocated()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms in rows)
    bwd_ms = sum(ms for k, ms in rows if "flash_attention_bwd" in k)
    fwd_ms = sum(ms for k, ms in rows
                 if "flash_attention" in k and "bwd" not in k)
    gemm_ms = sum(ms for k, ms in rows
                  if any(w in k for w in ("gemm", "nvjet", "cutlass")))
    tokens = QWEN_BATCH * QWEN_SEQ
    line = {"phase": "lm_train", "run": "qwen2.5-3b", "layers":
            cfg.num_layers, "d_model": cfg.d_model,
            "params": tfm.count_params(cfg), "batch": QWEN_BATCH,
            "seq": QWEN_SEQ, "microbatches": M, "lr": QWEN_LR,
            "noise_std": plan.noise_std, "init_s": init_s, "steps": steps,
            "step_s": steps[1]["s"], "tokens_per_s": tokens / steps[1]["s"],
            "peak_mem_bytes": peak,
            "device_total_bytes": torch.cuda.get_device_properties(
                0).total_memory,
            "ce_uniform": math.log(cfg.vocab_size),
            "profiled_step_s": steps[2]["s"],
            "profiled_device_busy_ms": busy,
            "profiled_attention_bwd_ms": bwd_ms,
            "profiled_attention_fwd_ms": fwd_ms,
            "profiled_gemm_ms": gemm_ms,
            "attention_bwd_share_of_busy": bwd_ms / busy if busy else None,
            "device_idle_share": 1.0 - busy / (steps[2]["s"] * 1e3),
            "top": sorted(rows, key=lambda r: -r[1])[:8]}
    del params, state, batches, seqs, prof
    torch.cuda.empty_cache()
    emit(line)
    want = cfg.num_layers * M
    ok = (M == 4 and all(math.isfinite(s["loss"]) for s in steps)
          and abs(steps[0]["ce"] - line["ce_uniform"]) <= QWEN_CE0_TOL
          and steps[1]["ce"] < steps[0]["ce"]
          and all(s["launches"] == want and s["launches_bwd"] == want
                  and s["launches_bf16"] == 0 and s["launches_bwd_bf16"] == 0
                  for s in steps))
    if not ok:
        raise AssertionError(f"Qwen2.5-3B's training steps failed a check "
                             f"(M = 4, finite losses, the first CE within "
                             f"{QWEN_CE0_TOL} of ln V, the second CE lower, "
                             f"{want} launches of each kernel a step): "
                             f"{line}")
    return {"launches": want, "launches_bwd": want}


# The twin's gate: examples/train_lm_cwfl.py --steps 300 on the CPU (JAX)
# ends at a CE of 8.254 (lm-6m, ln 4096 = 8.318); the twin, from its own
# draws, may end at most LM_TWIN_MARGIN above that.
LM_TWIN_JAX_CE = 8.254
LM_TWIN_MARGIN = 0.05


def lm_twin_phase() -> dict:
    """``examples/train_lm_cwfl_torch.py --steps 300`` on the card: its
    final CE under the JAX example's plus LM_TWIN_MARGIN, and its
    seconds."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_lm_cwfl_torch", ROOT / "examples" / "train_lm_cwfl_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with contextlib.redirect_stdout(sys.stderr):
        out = twin.main(["--steps", "300"])
    line = {"phase": "lm_train", "run": "examples/train_lm_cwfl_torch.py",
            "steps": 300, "seconds": out["seconds"],
            "steps_per_s": 300 / out["seconds"], "ce_first": out["ce"][0],
            "ce_final": out["ce"][-1],
            "ce_last25_mean": sum(out["ce"][-25:]) / 25,
            "gate": LM_TWIN_JAX_CE + LM_TWIN_MARGIN,
            "ce_uniform": math.log(4096)}
    emit(line)
    if not line["ce_final"] <= line["gate"]:
        raise AssertionError(f"the LM twin's final CE is above its gate: "
                             f"{line}")
    return line


# The other mixers, front ends and dense models trained at their published
# widths (the train phase): bf16 and remat, as the JAX package's dry run
# trains them (`src/repro/launch/dryrun.py`: DTYPE_OVERRIDES, remat for
# train shapes, params and optimizer state donated), through the shard-mode
# step with donation, JAX's train_4k sequence of 4,096 positions, the
# global batch cut from 256 to one microbatch of B rows (M = 1), the MoE
# models at their published capacity factor 1.25; the depth cut to what
# fits (PERF.md §4 has the reckoning): name, layers (None: all), B, the
# positions a row, SGD's rate.  xlstm-125m's sLSTM walks the tokens one at
# a time (host-bound: 41.8 s a step at 4,096, measured on one H100), so it
# trains 1,024 a row.  The rate: bf16 params round away an update far
# below their ulp, so 1e-2 moves them in a step; Qwen3-MoE's 128-way
# routers overshoot at 1e-2 (its load-balance loss rose by 18 % in one
# step while the CE fell, on one H100), so it takes JAX's default 1e-3.
TRAIN_RUNS = (
    ("qwen3-moe-235b-a22b", 4, 1, 4096, 1e-3),
    ("jamba-v0.1-52b", 8, 1, 4096, 1e-2),
    ("internvl2-2b", None, 2, 4096, 1e-2),
    ("whisper-tiny", None, 2, 4096, 1e-2),
    ("xlstm-125m", None, 1, 1024, 1e-2),
    ("phi4-mini-3.8b", None, 2, 4096, 1e-2),
)
# The reduced configurations whose shard step runs on the card against
# the CPU (`train_reference_run`): TRAIN_RUNS' and the two that do not
# train at their published width on one card, Kimi K2 (ROADMAP §1 has the
# reckoning) and llama3-405b; Kimi K2 also at its published head dim of
# 112, so that a step runs its MoE and the pad to 128 through the
# attention's backward.  name, head dim (None: the reduced config's).
TRAIN_REDUCED = tuple((run[0], None) for run in TRAIN_RUNS) + (
    ("kimi-k2-1t-a32b", None), ("kimi-k2-1t-a32b", 112),
    ("llama3-405b", None))
# The reduced step on the card against the CPU
# (f32, no channel noise, so that the update is lr times the gradient):
# each leaf's update within LM_REF_TOL of the CPU's, relative to its
# largest magnitude; xlstm-125m's gradient is ill-conditioned (a 1e-7
# change of the params moves it 9e-4; tests/test_torch_lm_train.py's
# XLSTM_GRAD_RTOL), so its update is held to that.
TRAIN_REF_TOL = {"xlstm-125m": 2e-3}
# The embedding table after a step, two runs of the same step: its largest
# difference over its largest magnitude (a few f32 ulps of a summed row).
EMBED_RERUN_TOL = 1e-6


def train_launches(cfg) -> tuple:
    """The attention kernels' launches in one remat train step of
    ``cfg``, counted from the configuration: ``(forward, backward)``.  A
    checkpointed period runs its attentions twice (the forward, then the
    recomputation in the backward); the audio encoder is not
    checkpointed (JAX's is not either), and every decoder block's
    cross-attention is."""
    attn = cfg.num_periods * sum(s.mixer == "attn" for s in cfg.pattern)
    enc = cfg.encoder_layers if cfg.frontend == "audio_stub" else 0
    cross = cfg.num_layers if cfg.frontend == "audio_stub" else 0
    periods = attn + cross
    return 2 * periods + enc, periods + enc


def train_reference_run(fa, name: str, head_dim=None) -> dict:
    """The reduced configuration's shard step (M = 1), its heads
    ``head_dim`` wide if given, on the card against the CPU from the same
    params and tokens: the update within LM_REF_TOL (TRAIN_REF_TOL), the
    loss within it; on the card remat on against off and the donated step
    against the functional one, bitwise, and the off step against
    itself."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import InputShape
    from repro_torch.models.inputs import make_batch
    from repro_torch.optim import sgd
    from repro_torch.training import dist_steps as ds
    from repro_torch.utils import tree_leaves, tree_map

    base = get_config(name, reduced=True)
    if head_dim is not None:
        base = base.replace(head_dim=head_dim)
    shape = InputShape("train", LM_REF_S, LM_REF_B, "train")
    params0 = tfm.init_params(0, base, device="cpu")
    batch0 = make_batch(2, base, LM_REF_S, LM_REF_B, kind="train",
                        device="cpu")

    def run(device, remat, donate):
        cfg = base.replace(remat=remat)
        params = tree_map(lambda a: a.clone().to(device), params0)
        batch = tree_map(lambda a: a.to(device), batch0)
        fn = ds.make_train_step(cfg, shape, lr=0.05, microbatches=1,
                                donate=donate)
        new, _, m = fn(params, sgd(0.05).init(params), batch,
                       torch.Generator(device).manual_seed(0))
        return tree_map(lambda a: a.cpu(), new), m["loss"].cpu()

    want_p, want_l = run("cpu", True, True)
    fa.launches = fa.launches_bf16 = 0
    fa.launches_bwd = fa.launches_bwd_bf16 = 0
    got_p, got_l = run(DEVICE, True, True)
    torch.cuda.synchronize()
    launched = {"f32": fa.launches, "bwd_f32": fa.launches_bwd}
    plain_p, plain_l = run(DEVICE, False, False)
    again_p, again_l = run(DEVICE, False, False)
    remat_p, remat_l = run(DEVICE, True, False)
    start = [x.float() for x in tree_leaves(params0)]

    def update_err(a, b):
        # Each leaf's update (new − old) against the CPU's, over its
        # largest magnitude; read back from the stored params, an update
        # carries their rounding, one f32 ulp of the leaf's largest param
        # a side, which is taken off first.
        errs = []
        for x, y, s in zip(tree_leaves(a), tree_leaves(b), start):
            ux, uy = x.float() - s, y.float() - s
            ulp = float(torch.finfo(torch.float32).eps * s.abs().max())
            gap = max(float((ux - uy).abs().max()) - 2 * ulp, 0.0)
            errs.append(gap / float(uy.abs().max()) if uy.abs().max() > 0
                        else gap)
        return max(errs)

    def bitwise(a, la, b, lb):
        # Every leaf but the embedding table bit for bit; the table's
        # gradient sums a token's rows in the gather's backward
        # (`index_put_` with accumulate: atomics on the card), in another
        # order run to run, so it is held to EMBED_RERUN_TOL, the same
        # for two runs of one step.
        rest = [(x, y) for k in a if k != "embed"
                for x, y in zip(tree_leaves(a[k]), tree_leaves(b[k]))]
        return (torch.equal(la, lb) and all(torch.equal(x, y)
                                            for x, y in rest)
                and rel_err(a["embed"], b["embed"]) <= EMBED_RERUN_TOL)

    tol = TRAIN_REF_TOL.get(name, LM_REF_TOL[torch.float32])
    fwd, bwd = train_launches(base.replace(remat=True))
    line = {"phase": "train",
            "run": f"{name}-reduced" + (f"-hd{head_dim}" if head_dim
                                        else ""),
            "layers": base.num_layers, "d_model": base.d_model,
            "hd": base.hd, "num_experts": base.num_experts,
            "loss_cuda": float(got_l), "loss_cpu": float(want_l),
            "loss_rel_err": rel_err(got_l, want_l),
            "update_rel_err": update_err(got_p, want_p), "tol_rel": tol,
            "remat_bitwise": bitwise(remat_p, remat_l, plain_p, plain_l),
            "donated_bitwise": bitwise(got_p, got_l, remat_p, remat_l),
            "plain_bitwise_rerun": bitwise(again_p, again_l, plain_p,
                                           plain_l),
            "embed_rel_diff": {
                "remat": rel_err(remat_p["embed"], plain_p["embed"]),
                "donated": rel_err(got_p["embed"], remat_p["embed"]),
                "rerun": rel_err(again_p["embed"], plain_p["embed"])},
            "tol_embed_rel": EMBED_RERUN_TOL,
            "launches": launched,
            "launches_expected": {"f32": fwd, "bwd_f32": bwd}}
    emit(line)
    if not (line["loss_rel_err"] <= tol and line["update_rel_err"] <= tol
            and line["remat_bitwise"] and line["donated_bitwise"]
            and launched == line["launches_expected"]):
        raise AssertionError(f"the reduced {name}'s train step on the card: "
                             f"{line}")
    return line


def train_full_width_run(fa, name: str, layers, B: int, seq: int,
                         lr: float) -> dict:
    """Three donated shard-mode steps at the published width, bf16, remat,
    M = 1, B × seq positions, SGD at ``lr``: steps 1 and 2 on one batch
    (the second loss below the first), step 3 on another.  Seconds a step, tokens/s,
    peak memory, each attention kernel's launches a step against
    `train_launches`."""
    from repro_torch.configs import get_config
    from repro_torch.dist.fl_integration import make_fl_plan
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import InputShape
    from repro_torch.models.inputs import make_batch
    from repro_torch.optim import sgd
    from repro_torch.training import dist_steps as ds

    published = get_config(name)
    cfg = published.replace(param_dtype="bfloat16",
                            compute_dtype="bfloat16", remat=True)
    cuts = {"dtype": f"{published.param_dtype} -> bfloat16",
            "global_batch": f"256 -> {B}"}
    if seq != 4096:
        cuts["seq"] = f"4096 -> {seq}"
    if layers is not None and layers != published.num_layers:
        cfg = cfg.replace(num_layers=layers)
        cuts["layers"] = f"{published.num_layers} -> {layers}"
    shape = InputShape("train_4k", seq, B, "train")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = make_fl_plan(4, 3, 0, snr_db=40.0, device=DEVICE)
    params = tfm.init_params(0, cfg, device=DEVICE)
    batches = [make_batch(seed, cfg, seq, B, kind="train",
                          device=DEVICE) for seed in (1, 2)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fn = ds.make_train_step(cfg, shape, plan=plan, lr=lr,
                            microbatches=1, donate=True)
    state = sgd(lr).init(params)
    noise = torch.Generator(DEVICE).manual_seed(3)
    steps = []
    for batch in (batches[0], batches[0], batches[1]):
        fa.launches = fa.launches_bwd = 0
        fa.launches_bf16 = fa.launches_bwd_bf16 = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state, m = fn(params, state, batch, noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps.append({"s": seconds, "ce": float(m["ce"]),
                      "loss": float(m["loss"]),
                      "launches_bf16": fa.launches_bf16,
                      "launches_bwd_bf16": fa.launches_bwd_bf16,
                      "launches_f32": fa.launches + fa.launches_bwd})
    donated = out is params
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = train_launches(cfg)
    tokens = B * seq
    line = {"phase": "train", "run": name, "reduced": cuts,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "hd": cfg.hd, "params": tfm.count_params(cfg),
            "param_bytes": tfm.count_params(cfg) * 2, "batch": B,
            "seq": seq, "microbatches": 1, "lr": lr,
            "capacity_factor": (cfg.capacity_factor if cfg.num_experts
                                else None),
            "remat": True, "donated": donated, "init_s": init_s,
            "steps": steps, "step_s": steps[1]["s"],
            "tokens_per_s": tokens / steps[1]["s"],
            "peak_mem_bytes": peak,
            "device_total_bytes":
                torch.cuda.get_device_properties(0).total_memory,
            "ce_uniform": math.log(cfg.vocab_size),
            "launches_expected": {"fwd": fwd, "bwd": bwd}}
    del params, out, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    ok = (donated and all(math.isfinite(x["loss"]) for x in steps)
          and steps[1]["loss"] < steps[0]["loss"]
          and all(x["launches_bf16"] == fwd and x["launches_bwd_bf16"] == bwd
                  and x["launches_f32"] == 0 for x in steps))
    if not ok:
        raise AssertionError(f"{name}'s training at full width failed a "
                             f"check (donated, finite losses, the second "
                             f"below the first, {fwd} forward and {bwd} "
                             f"backward launches of the bf16 kernels a "
                             f"step): {line}")
    return line


def train_phase(fa) -> dict:
    """Every configuration of TRAIN_REDUCED: its reduced shard step on the
    card against the CPU; then each of TRAIN_RUNS: three steps at full
    width.  Returns each bf16 attention kernel's launches over the
    full-width steps, by configuration."""
    for name, head_dim in TRAIN_REDUCED:
        train_reference_run(fa, name, head_dim)
    launches = {}
    for name, *run in TRAIN_RUNS:
        line = train_full_width_run(fa, name, *run)
        launches[name] = {
            "bf16": sum(x["launches_bf16"] for x in line["steps"]),
            "bwd_bf16": sum(x["launches_bwd_bf16"] for x in line["steps"])}
    return launches


# The serve twin (`examples/serve_decode_torch.py`) with a serving-time
# window, card against CPU on the same weights and prompt: the reduced
# Qwen2.5-3B (a window of 8 on a 32-token prompt) and phi4-mini-3.8b at its
# published width, two layers, f32 (a window of 32 on a 64-token prompt).
# The last logits: the reduced within MIXER_REF_TOL, the published width
# within TWIN_TOL (f32 sums over 3,072- and 8,192-term rows in other
# orders).
TWIN_RUNS = (
    # arch, full width, layers, batch, prompt, tokens, window
    ("qwen2.5-3b", False, None, 2, 32, 8, 8),
    ("phi4-mini-3.8b", True, 2, 1, 64, 4, 32),
)
TWIN_TOL = 1e-3


def serve_twin_phase(fa) -> dict:
    """``examples/serve_decode_torch.py``: its ``main`` on the card (the
    reduced default, 8 tokens), then its ``serve`` with a window at
    TWIN_RUNS on the card against the CPU: the same tokens, the last
    logits within tolerance, the f32 kernel once a layer in the prefill.
    Returns the kernel's launches in the card's runs."""
    import importlib.util

    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch
    from repro_torch.utils import tree_map

    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with contextlib.redirect_stdout(sys.stderr):
        out = twin.main(["--tokens", "8"])
    emit({"phase": "serve_twin", "run": "main", "seconds": out["seconds"],
          "tokens": out["tokens"].tolist()})
    launches = 0
    for arch, full, layers, B, prompt, n, window in TWIN_RUNS:
        cfg = twin.config(arch, full, layers, "float32")
        params = tfm.init_params(0, cfg, device="cpu")
        batch = make_batch(1, cfg, prompt, B, kind="prefill", device="cpu")
        want_t, want_l = twin.serve(params, batch, cfg, n, window)
        fa.launches = fa.launches_bf16 = 0
        t0 = time.perf_counter()
        got_t, got_l = twin.serve(tree_map(lambda a: a.to(DEVICE), params),
                                  tree_map(lambda a: a.to(DEVICE), batch),
                                  cfg, n, window)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tol = TWIN_TOL if full else MIXER_REF_TOL
        line = {"phase": "serve_twin", "run": arch, "published_width": full,
                "layers": cfg.num_layers, "d_model": cfg.d_model,
                "batch": B, "prompt": prompt, "tokens": n,
                "window_override": window, "card_s": seconds,
                "tokens_equal": torch.equal(got_t.cpu(), want_t),
                "logits_abs_err": float((got_l.cpu() - want_l).abs().max()),
                "tol_logits_abs": tol,
                "launches": {"f32": fa.launches, "bf16": fa.launches_bf16},
                "launches_expected": {"f32": cfg.num_layers, "bf16": 0}}
        launches += fa.launches
        del params, batch
        emit(line)
        if not (line["tokens_equal"] and line["logits_abs_err"] <= tol
                and line["launches"] == line["launches_expected"]):
            raise AssertionError(f"the serve twin on the card disagrees "
                                 f"with the CPU: {line}")
    return {"f32": launches}


# ---------------------------------------------------------------------------
# The one-card dry run (`repro_torch.launch`): the meta-device plan of every
# (arch × input shape), and rows at JAX's long shapes on the card.
# ---------------------------------------------------------------------------

LAUNCH_CHUNK = 1024        # query rows a chunk of the plain attention
LAUNCH_DECODE_TOL = 1e-2   # bf16 decode attention against the f32 plain
LAUNCH_PREFILL_BATCH = 2   # the prefill row's batch, a cut for time
LAUNCH_DECODE_BATCH = 8
# Kernel 4b at 32,768 rows against its plain version: the largest relative
# L2 error over blocks of LAUNCH_CHUNK query rows.  A causal row that sees
# n keys of unit normals has outputs of about n^-1/2, so one absolute
# limit would hold the late rows, the new geometry, far more loosely than
# the early ones.  On an NVIDIA H100 80GB HBM3 (700 W) the kernel reads
# 6.2e-4 and a plain version that drops one 128-key tile in the late rows
# 6.2e-2 to 6.8e-2; the limit sits between them.
LAUNCH_32K_REL_L2 = 1e-2
# The key tile a wrong kernel drops in the late rows, to show the measure
# sees it: keys [S - 8192, S - 8192 + 128).
LAUNCH_DROP_TILE = 128


def chunked_plain_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                            scale=None, chunk=LAUNCH_CHUNK, drop=None):
    """`flash_attention_ref`'s arithmetic (f32 scores, an exact softmax) a
    chunk of query rows at a time, each chunk against the keys its rows
    may see: at 32,768 rows the whole score matrix of 16 heads would take
    69 GB.  ``drop``: ``(k0, k1)``, keys masked out of every row (a wrong
    kernel, for the check's own sensitivity)."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    for a in range(0, Sq, chunk):
        b = min(a + chunk, Sq)
        lo = max(0, a - window + 1) if window > 0 else 0
        hi = b if causal else k.shape[2]
        qg = (q[:, :, a:b].float() * scale).reshape(B, KV, H // KV, b - a, D)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, k[:, :, lo:hi].float())
        if cap > 0.0:
            s = cap * torch.tanh(s / cap)
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones_like(qp >= kp)
        if causal:
            mask &= kp <= qp
        if window > 0:
            mask &= kp > qp - window
        if drop is not None:
            mask &= (kp < drop[0]) | (kp >= drop[1])
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, v[:, :, lo:hi].float())
        out[:, :, a:b] = o.reshape(B, H, b - a, D).to(q.dtype)
        del s, p, o
    return out


def launch_plan_phase() -> list:
    """Every (arch × input shape) planned on the meta device: one line a
    row; each ``ok``, ``does_not_fit`` with its bytes or ``skip`` with
    JAX's reason; Kimi K2 × train_4k does not fit, whisper × long_500k is
    skipped."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch import dryrun
    from repro_torch.models.config import INPUT_SHAPES

    card = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    rows = []
    for arch in ARCH_NAMES:
        for shape in INPUT_SHAPES:
            r = dryrun.plan(arch, shape, card_bytes=card)
            rows.append(r)
            emit({"phase": "launch_plan", **r})
    seconds = time.perf_counter() - t0
    status = {(r["arch"], r["shape"]): r["status"] for r in rows}
    emit({"phase": "launch_plan", "rows": len(rows), "seconds": seconds,
          "status": {s: sum(v == s for v in status.values())
                     for s in ("ok", "does_not_fit", "skip")}})
    if (len(rows) != 40
            or status[("kimi-k2-1t-a32b", "train_4k")] != "does_not_fit"
            or status[("whisper-tiny", "long_500k")] != "skip"
            or any(v not in ("ok", "does_not_fit", "skip")
                   for v in status.values())):
        raise AssertionError(f"the dry run's plan: {status}")
    return rows


def launch_row_line(rec: dict) -> dict:
    """The line of a row run on the card: its cut, predicted and measured
    peak, seconds a step and roofline terms."""
    run, roof = rec.get("run", {}), rec.get("roofline", {})
    return {"phase": "launch", "arch": rec["arch"], "shape": rec["shape"],
            "status": rec["status"], "reduced": rec.get("reduced"),
            "batch": rec.get("global_batch"),
            "layers": rec.get("num_layers"),
            "window_override": rec.get("window_override"),
            "predicted_peak_bytes": rec.get("bytes", {}).get("total"),
            "predicted": rec.get("bytes"),
            "peak_bytes": run.get("peak_bytes"),
            "step_s": run.get("step_s"), "steps_s": run.get("steps_s"),
            "finite": run.get("finite"),
            "flops": roof.get("flops"), "hbm_bytes": roof.get("hbm_bytes"),
            "t_compute_s": roof.get("t_compute_s"),
            "t_memory_s": roof.get("t_memory_s"), "bound": roof.get("bound"),
            "model_flops": roof.get("model_flops"), "mfu": roof.get("mfu"),
            "roofline_share": roof.get("share"), "error": rec.get("error")}


def launch_run(fa, arch: str, shape: str, *, max_batch=None,
               reps: int = 2, params=None) -> dict:
    """`dryrun.run_one`'s row with the bf16 kernel's launches counted."""
    from repro_torch.launch import dryrun

    fa.launches = fa.launches_bf16 = 0
    rec = dryrun.run_one(arch, shape, device=DEVICE, reps=reps,
                         max_batch=max_batch, params=params)
    line = launch_row_line(rec)
    line["launches"] = {"f32": fa.launches, "bf16": fa.launches_bf16}
    emit(line)
    if rec["status"] != "ok" or not rec["run"]["finite"]:
        raise AssertionError(f"{arch} × {shape} on the card: {line}")
    return line


def blockwise_rel_l2(got, want, rows: int = LAUNCH_CHUNK) -> list:
    """``‖got − want‖ / ‖want‖`` over each block of ``rows`` query rows,
    all batches and heads together."""
    out = []
    for a in range(0, want.shape[2], rows):
        w = want[:, :, a:a + rows].float()
        d = got[:, :, a:a + rows].float() - w
        out.append(float(torch.linalg.vector_norm(d)
                         / torch.linalg.vector_norm(w)))
    return out


def launch_kernel_32k(fa) -> dict:
    """Kernel 4b at Qwen2.5-3B's prefill_32k geometry, (1, 16, 2, 32,768,
    128, causal): against its plain version run in query chunks, held to
    LAUNCH_32K_REL_L2 in every block of rows; the same measure of a plain
    version that drops a key tile in the late rows must exceed it.  Timed
    beside SDPA (``enable_gqa``); its operations bound."""
    import torch.nn.functional as F
    from repro_torch.launch.roofline import unmasked_pairs

    B, H, KV, S, D = 1, 16, 2, 32768, 128
    g = torch.Generator(DEVICE).manual_seed(32)
    q, k, v = (torch.randn(B, n, S, D, generator=g, device=DEVICE).to(
        torch.bfloat16) for n in (H, KV, KV))
    fa.launches_bf16 = 0
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = chunked_plain_attention(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    rel = blockwise_rel_l2(got, want)
    k0 = S - 8192
    wrong = blockwise_rel_l2(chunked_plain_attention(
        q, k, v, causal=True, drop=(k0, k0 + LAUNCH_DROP_TILE)), want)
    bitwise_rerun = torch.equal(got, fa.flash_attention(q, k, v,
                                                        causal=True))
    ops = 4.0 * D * H * B * unmasked_pairs(S, 0)
    bytes_ = 2 * (2 * q.numel() + k.numel() + v.numel())
    bw, _, bf16_peak, _ = card_peaks(torch.cuda.get_device_name(0))
    bound_ms = max(ops / bf16_peak, bytes_ / bw) * 1e3
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=5)
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=5)
    line = {"phase": "launch", "kernel": "flash_attention_bf16",
            "geometry": [B, H, KV, S, D, "causal"], "max_abs_err": err,
            "rel_l2_blocks": {"rows": LAUNCH_CHUNK, "max": max(rel),
                              "first": rel[0], "last": rel[-1]},
            "tol": LAUNCH_32K_REL_L2,
            "wrong_kernel_rel_l2": {"drop_keys": [k0, k0 + LAUNCH_DROP_TILE],
                                    "max": max(wrong), "last": wrong[-1]},
            "bitwise_rerun": bitwise_rerun,
            "ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "ops": ops}
    del q, k, v, got, want
    torch.cuda.empty_cache()
    emit(line)
    above_bound("flash_attention_bf16 at 32k", {"ms": ms}, bound_ms)
    if not (max(rel) <= LAUNCH_32K_REL_L2 < max(wrong) and bitwise_rerun):
        raise AssertionError(f"kernel 4b at 32,768 rows: {line}")
    return line


def gemma_decode_32k(fa) -> dict:
    """gemma2-9b × decode_32k, whole depth, bf16: the planned step at the
    plan's batch (cut further to LAUNCH_DECODE_BATCH), then the gate at
    batch 1: the decode of token 32,768 against a 32,768-token prefill
    (`decode_gate`, relative L2 within MIXER_BF16_REL_L2), on the same
    parameters."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch

    arch, shape_name = "gemma2-9b", "decode_32k"
    rec = dryrun.plan(arch, shape_name, max_batch=LAUNCH_DECODE_BATCH,
                      card_bytes=torch.cuda.get_device_properties(0)
                      .total_memory)
    cfg, shape = dryrun.planned_config(rec)
    gc.collect()
    torch.cuda.empty_cache()
    params = tfm.init_params(0, cfg, device=DEVICE)
    line = launch_run(fa, arch, shape_name, max_batch=LAUNCH_DECODE_BATCH,
                      reps=3, params=params)
    P = shape.seq_len - 1
    batch = make_batch(7, cfg, P, 1, kind="prefill", device=DEVICE)
    fa.launches_bf16 = 0
    t0 = time.perf_counter()
    gate = decode_gate(params, batch, cfg, P, n=1)
    torch.cuda.synchronize()
    gate_line = {"phase": "launch", "arch": arch, "gate": "decode_32k",
                 "prompt": P, "decoded_position": P,
                 "rel_l2": gate["rel_l2"], "max_abs": gate["max_abs"],
                 "argmax_agrees": gate["argmax_agrees"],
                 "limit": MIXER_BF16_REL_L2, "seconds":
                 time.perf_counter() - t0,
                 "launches_bf16": fa.launches_bf16}
    emit(gate_line)
    del params, batch, gate
    gc.collect()
    torch.cuda.empty_cache()
    if not max(gate_line["rel_l2"]) <= MIXER_BF16_REL_L2:
        raise AssertionError(f"gemma2-9b × decode_32k: {line} {gate_line}")
    return {"row": line, "gate": gate_line}


def decode_attention_524k() -> dict:
    """`decode_attention_delta` at 524,288 cache positions with gemma2-9b's
    geometry (16 heads on 8 KV heads of 256, softcap 50), bf16, against
    a plain f32 computation a chunk of positions at a time."""
    from repro_torch.models.attention import decode_attention_delta

    B, H, KV, D, S, cap = 1, 16, 8, 256, 524288, 50.0
    g = torch.Generator(DEVICE).manual_seed(5)
    kc, vc = (torch.randn(B, S, KV, D, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(2))
    q = torch.randn(B, 1, H, D, generator=g, device=DEVICE).to(
        torch.bfloat16)
    kn, vn = (torch.randn(B, 1, KV, D, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(2))
    pos = S - 1
    got = decode_attention_delta(q, kc, vc, kn, vn, pos, cap=cap).float()
    qg = (q.float() * D ** -0.5).reshape(B, KV, H // KV, D)
    scores = []
    for a in range(0, S, 65536):
        scores.append(torch.einsum("bkgd,bskd->bkgs", qg,
                                   kc[:, a:a + 65536].float()))
    scores.append(torch.einsum("bkgd,bkd->bkg", qg,
                               kn[:, 0].float())[..., None])
    s = torch.cat(scores, dim=-1)
    s = cap * torch.tanh(s / cap)
    s[..., pos:S] = -torch.inf          # slots at and after pos are empty
    p = torch.softmax(s, dim=-1)
    want = torch.zeros(B, KV, H // KV, D, device=DEVICE)
    for a in range(0, S, 65536):
        want += torch.einsum("bkgs,bskd->bkgd", p[..., a:a + 65536],
                             vc[:, a:a + 65536].float())
    want += p[..., -1:] * vn[:, 0, :, None].float()
    want = want.reshape(B, 1, H, D)
    err = float((got - want).abs().max() / want.abs().max())
    line = {"phase": "launch", "check": "decode_attention_524k",
            "positions": S, "geometry": [B, H, KV, D], "cap": cap,
            "rel_max_err": err, "tol": LAUNCH_DECODE_TOL}
    del kc, vc, s, p
    torch.cuda.empty_cache()
    emit(line)
    if not err <= LAUNCH_DECODE_TOL:
        raise AssertionError(f"decode attention at 524,288 positions: "
                             f"{line}")
    return line


def windowed_decode_reference() -> dict:
    """phi4-mini's long_500k variant reduced: one decode step at position
    524,287 of a ring cache of the windowed config's slots (far past the
    window), on the card against the CPU from the same caches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import InputShape
    from repro_torch.training import dist_steps as ds
    from repro_torch.utils import tree_map

    cfg = get_config("phi4-mini-3.8b", reduced=True)
    shape = InputShape("long_500k", 524288, 2, "decode")
    step = ds.make_decode_step(cfg, shape, window_override=32)
    specs = dryrun.decode_cache_specs(step.cfg, 2, shape.seq_len)
    gen = torch.Generator("cpu").manual_seed(9)
    caches = dryrun._random_caches(specs, gen, "cpu")
    params = tfm.init_params(0, cfg, device="cpu")
    token = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
    want, _ = step(params, token, caches, shape.seq_len - 1)
    got, _ = step(tree_map(lambda a: a.to(DEVICE), params),
                  token.to(DEVICE), tree_map(lambda a: a.to(DEVICE), caches),
                  shape.seq_len - 1)
    err = float((got.cpu() - want).abs().max())
    line = {"phase": "launch", "check": "windowed_decode_reduced",
            "arch": "phi4-mini-3.8b", "window_override": 32,
            "position": shape.seq_len - 1,
            "ring_slots": int(specs["b0"]["mixer"]["k"].shape[2]),
            "logits_abs_err": err, "tol": MIXER_REF_TOL}
    emit(line)
    if not err <= MIXER_REF_TOL:
        raise AssertionError(f"the windowed decode past its window: {line}")
    return line


def launch_phase(fa) -> dict:
    """The one-card dry run's rows (`repro_torch.launch`): the plan of all
    40 rows; qwen2.5-3b × prefill_32k at whole depth through kernel 4b at
    32,768 rows (and the kernel against its chunked plain version there);
    gemma2-9b × decode_32k at whole depth with its gate; the long_500k
    rows (phi4-mini windowed, Jamba and Gemma-2 native) with their
    references.  Returns the bf16 kernel's launches in the prefill row."""
    t0 = time.perf_counter()
    launch_plan_phase()
    kernel = launch_kernel_32k(fa)
    prefill = launch_run(fa, "qwen2.5-3b", "prefill_32k",
                         max_batch=LAUNCH_PREFILL_BATCH)
    if prefill["launches"] != {"f32": 0, "bf16": 36 * 3}:
        raise AssertionError(f"qwen2.5-3b × prefill_32k launched "
                             f"{prefill['launches']}, not 36 bf16 launches "
                             f"a prefill in 3 prefills")
    gemma = gemma_decode_32k(fa)
    long_rows = [launch_run(fa, arch, "long_500k", reps=2)
                 for arch in ("phi4-mini-3.8b", "jamba-v0.1-52b",
                              "gemma2-9b")]
    decode_attention_524k()
    windowed_decode_reference()
    emit({"phase": "launch", "seconds": time.perf_counter() - t0})
    return {"kernel": kernel, "prefill_launches": prefill["launches"]["bf16"],
            "gate_launches": gemma["gate"]["launches_bf16"],
            "long": long_rows}


def literal_weight_phase(kmod) -> dict:
    """One CWFL round in the literal-weight modes (``normalize=False``,
    ``precode=False``) at the paper's MNIST width through kernel 1, on the
    card against the CPU from the same state, params and unit normals:
    the FL tolerance (1e-4) relative to each output's scale."""
    from repro_torch.core import cwfl
    from repro_torch.utils.pytree import tree_leaves, tree_map

    init, apply, loss, topo, xs, ys, xte, yte = full_width_workload()
    K = int(xs.shape[0])
    state = cwfl.setup(topo, cwfl.CWFLConfig(num_clusters=3, snr_db=40.0),
                       0)
    g = torch.Generator(DEVICE).manual_seed(11)
    params = init(torch.Generator(DEVICE).manual_seed(0))
    stacked = tree_map(lambda v: torch.stack([v + 0.01 * torch.randn(
        v.shape, generator=g, device=DEVICE) for _ in range(K)]), params)
    d = sum(x[0].numel() for x in tree_leaves(stacked))
    noise = tuple(torch.randn(3, d, generator=g, device=DEVICE)
                  for _ in range(2))
    out = []
    for normalize, precode in ((False, True), (True, False),
                               (False, False)):
        kmod.launches = 0
        new, cons = cwfl.aggregate(stacked, state, noise,
                                   normalize=normalize, precode=precode)
        launches = kmod.launches
        cpu = state_to(state, "cpu")
        want_new, want_cons = cwfl.aggregate(
            tree_map(lambda v: v.cpu(), stacked), cpu,
            tuple(x.cpu() for x in noise), normalize=normalize,
            precode=precode)
        err = max(rel_err(a.cpu(), b) for a, b in zip(
            tree_leaves(new) + tree_leaves(cons),
            tree_leaves(want_new) + tree_leaves(want_cons)))
        line = {"phase": "literal_weights", "K": K, "C": 3, "d": d,
                "normalize": normalize, "precode": precode,
                "launches": launches, "rel_err": err, "tol": 1e-4}
        emit(line)
        out.append(line)
        if not (launches == 1 and err <= 1e-4):
            raise AssertionError(f"a literal-weight round on the card: "
                                 f"{line}")
    return {"launches": sum(x["launches"] for x in out)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    sys.path.insert(0, str(ROOT / "src"))
    # torch.compile (the flex_attention yardstick) keeps its caches in the
    # checkout's git-ignored build directory.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from repro_torch.kernels import cwfl_round as kmod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ota_aggregate as omod
    from repro_torch.kernels._build import build, library_path
    from repro_torch.kernels.ref import (cwfl_round_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref,
                                         ota_aggregate_ref)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # The JAX reference computes in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD.append(smi)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    sources = [kmod.SOURCE, omod.SOURCE, *fa.SOURCES, fa.SOURCE_BWD]
    cold = not any(library_path(src).exists() for src in sources)
    t0 = time.perf_counter()
    build(sources)
    kmod._library()
    omod._library()
    for dtype in (torch.float32, torch.bfloat16):
        fa._library(dtype)
        fa._library_bwd(dtype)
    seconds = time.perf_counter() - t0
    libraries = {}
    for names, source in ((["cwfl_round", "cwfl_round_guard"], kmod.SOURCE),
                          (["ota_aggregate"], omod.SOURCE),
                          (["flash_attention"], fa.SOURCE_F32),
                          (["flash_attention_bf16"], fa.SOURCE_BF16),
                          (["flash_attention_bwd", "flash_attention_bwd_bf16"],
                           fa.SOURCE_BWD)):
        log = library_path(source).with_suffix(".log").read_text()
        libraries[library_path(source).name] = {
            "kernels": names,
            "instantiations": log.count("Compiling entry function"),
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit({"phase": "build",
          "kernels": ["cwfl_round", "cwfl_round_guard", "ota_aggregate",
                      "flash_attention", "flash_attention_bf16",
                      "flash_attention_bwd", "flash_attention_bwd_bf16"],
          "seconds": seconds, "cold": cold, "libraries": libraries})

    cwfl_row, cwfl_cifar_row, cwfl_c4_row = kernel_phase(kmod,
                                                         cwfl_round_ref)
    guard_row, = kernel_phase(kmod, cwfl_round_ref, guard=True)
    ota_row, ota_c1_row, ota_c50_row, ota_cifar_row = ota_kernel_phase(
        omod, ota_aggregate_ref)
    fa_row, fa_bf16_row = flash_kernel_phase(fa, flash_attention_ref)
    batched_cwfl_row, batched_guard_row, batched_ota_row = \
        batched_kernel_phase(kmod, omod, cwfl_round_ref, ota_aggregate_ref)
    rows = [cwfl_row, guard_row, ota_row, ota_c1_row, ota_c50_row, fa_row,
            fa_bf16_row, cwfl_cifar_row, cwfl_c4_row, ota_cifar_row,
            batched_cwfl_row, batched_guard_row, batched_ota_row]
    reference_phase("paper-static")
    reference_phase("flaky-clients", "flaky-clients")
    dead = reference_phase("dead-cluster", dead_cluster_scenario(),
                           rounds=4)
    if not any(dead):
        raise AssertionError(f"the dead-cluster run handed the kernel no "
                             f"dead row: {dead}")
    for name, *_ in STRATEGY_RUNS:
        reference_phase(name, strategy=name)
    reference_phase("cotaf-flaky-clients", "flaky-clients",
                    strategy="cotaf")
    cnn_reference_phase("cwfl")
    cnn_reference_phase("cotaf", mu_prox=0.1)
    lm_reference_phase(fa)
    cwfl_row["launches"], static = slice_phase(kmod, omod)
    ota_row["launches"] = dist_phase(omod, kmod, static)
    guard_row["launches"] = scenario_phase(kmod, omod, static["test_acc"])
    ota_c1_row["launches"], ota_c50_row["launches"] = strategies_phase(
        omod, kmod)
    quickstart_phase(omod, kmod)
    paper_launches = paper_phase(omod, kmod)
    for row in (cwfl_cifar_row, cwfl_c4_row, ota_cifar_row):
        row["launches"] = paper_launches[row["name"]]
    guard_row["launches_scan_profiled"] = trajectory_phase(kmod)
    cudnn_flag_phase()
    mc_launches = monte_carlo_phase(kmod, omod)
    batched_cwfl_row["launches"] = mc_launches["cwfl"]
    batched_ota_row["launches"] = mc_launches["cotaf"]
    batched_guard_row["launches"] = dynamic_sweep_phase(kmod, omod)
    obs = obs_phase(kmod, omod)
    cwfl_row["launches_obs"] = obs["paper_static_telemetry"]["cwfl_round"]
    guard_row["launches_obs"] = obs["resume_both"]["cwfl_round_guard"]
    batched_guard_row["launches_obs"] = obs["head_failure_sweep"][
        "cwfl_round_guard"]
    ota_c1_row["launches_obs"] = obs["cotaf"]["ota_aggregate"]
    ota_c50_row["launches_obs"] = obs["decentralized"]["ota_aggregate"]
    cwfl_cifar_row["launches_obs"] = obs["cifar"]["cwfl_round"]
    fa_row["launches"], params, batch, cfg, gate = serve_phase(fa)
    serve_profile_phase(params, batch, cfg)
    del params
    torch.cuda.empty_cache()
    fa_bf16_row["launches"] = serve_bf16_phase(fa, flash_attention_ref,
                                               gate, batch)
    del gate, batch
    torch.cuda.empty_cache()
    mixers = mixers_phase(fa)
    for row, kernel in ((fa_row, "f32"), (fa_bf16_row, "bf16")):
        row["launches_mixers"] = {name: n[kernel] for name, n in
                                  mixers.items() if n[kernel]}
    profile_phase()
    profile_phase("head-failure")
    cifar_profile_phase()
    bwd_row, bwd_bf16_row = fa_bwd_kernel_phase(fa, flash_attention_ref,
                                                flash_attention_bwd_ref)
    rows += [bwd_row, bwd_bf16_row]
    reference = lm_train_reference_phase(fa, kmod)
    bwd_bf16_row["launches"] = reference["shard_bf16"]["launches_bwd_bf16"]
    fa_bf16_row["launches_train"] = reference["shard_bf16"]["launches_bf16"]
    cwfl_row["launches_replica"] = reference["replica_f32"]["cwfl_round"]
    qwen = lm_qwen_phase(fa)
    bwd_row["launches"] = qwen["launches_bwd"]
    fa_row["launches_train"] = qwen["launches"]
    lm_twin_phase()
    trained = train_phase(fa)
    fa_bf16_row["launches_train_mixers"] = {
        name: n["bf16"] for name, n in trained.items() if n["bf16"]}
    bwd_bf16_row["launches_train_mixers"] = {
        name: n["bwd_bf16"] for name, n in trained.items() if n["bwd_bf16"]}
    fa_row["launches_serve_twin"] = serve_twin_phase(fa)["f32"]
    cwfl_row["launches_literal"] = literal_weight_phase(kmod)["launches"]
    launch = launch_phase(fa)
    fa_bf16_row["launches_launch"] = {
        "qwen2.5-3b prefill_32k": launch["prefill_launches"],
        "gemma2-9b decode_32k gate": launch["gate_launches"]}
    fa_bf16_row["geometry_32k"] = {
        k: launch["kernel"][k] for k in ("geometry", "ms", "sdpa_ms",
                                         "bound_ms", "max_abs_err",
                                         "rel_l2_blocks",
                                         "wrong_kernel_rel_l2")}

    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
