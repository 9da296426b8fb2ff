"""The one-card dry run (port of `repro.launch.dryrun`): every (arch ×
input shape) of ``INPUT_SHAPES``, planned on the ``meta`` device and run on
the card.

JAX lowers and compiles each combination on a 256- or 512-chip mesh of
fake devices without allocating.  One card has no mesh, so its
counterpart has two phases:

1. `plan` builds the parameters, the batch and the decode caches on the
   ``meta`` device (shapes, no storage), counts the bytes of the
   parameters, the gradients (training donates them), the caches, and
   reckons the activations and the logits from the shapes.  It then cuts
   the row to fit the card with a margin: first the batch, halved from
   the shape's global batch, then the depth in whole periods; sequence
   length and every width stay as published.  Each cut goes into the
   row's ``reduced``.  A row that does not fit at batch 1 and one period
   is ``does_not_fit`` with its bytes; whisper × long_500k is skipped with
   JAX's reason.
2. `run_one` runs the planned step on the card: one warm-up, then a few
   timed steps behind a synchronize, the peak memory against the plan's,
   and the H100 roofline (`repro_torch.launch.roofline`).

The rows are resumable JSON, as JAX's ``main`` writes them, by default at
``results_torch/dryrun.json`` (never JAX's ``results/dryrun.json``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --meta-only \
        --device cpu          # the plan alone, no card

Left out: ``parse_collectives`` and ``collective_bytes_of_line`` read the
collectives out of XLA's compiled HLO; one card runs no collective and
compiles no HLO, so they have no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as tfm
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.models.inputs import text_len
from repro_torch.training import dist_steps as ds
from repro_torch.training.serve import pad_caches
from repro_torch.utils.pytree import tree_leaves

# ---------------------------------------------------------------------------
# long_500k policy (JAX's): native for state-bounded archs, sliding-window
# serving for full-attention archs, skip whisper.
# ---------------------------------------------------------------------------

LONG_NATIVE = {"xlstm-125m", "jamba-v0.1-52b", "gemma2-9b"}
LONG_SWA = {"phi4-mini-3.8b", "qwen2.5-3b", "llama3-405b",
            "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "internvl2-2b"}
LONG_SKIP = {"whisper-tiny": "enc-dec audio: 500k-token decode is "
                             "semantically void for 30s audio"}
SWA_WINDOW = 32768

DTYPE_OVERRIDES = dict(param_dtype="bfloat16", compute_dtype="bfloat16")

# What torch reports as an NVIDIA H100 80GB HBM3's total memory, the card
# a plan is cut for when none is present.
CARD_BYTES = 85_017_624_576
# The plan leaves this share of the card free: the allocator's
# fragmentation and what the reckoning does not see.
MARGIN = 0.10

DEFAULT_OUT = "results_torch/dryrun.json"


def prepare_cfg(arch: str, shape: InputShape) -> ArchConfig:
    """JAX's base `prepare_cfg` on one card (``dp`` = 1), field for field.

    ``moe_shards`` (1 here) and ``act_spec`` are mesh hints: the port
    keeps the fields, and they change nothing it computes.  JAX's
    ``for_cost`` unrolling and its ``variant`` options (``gqarep``,
    ``seqact``, ``noact``) steer XLA's lowering and the sharding of the
    activations; one card lowers nothing and shards nothing, so they have
    no counterpart here.  ``ssm_chunk`` and ``mlstm_chunk`` are the chunk
    lengths of the port's scans too."""
    cfg = get_config(arch).replace(**DTYPE_OVERRIDES)
    cfg = cfg.replace(moe_shards=1, act_spec=("data", None, "model"))
    if shape.kind == "train":
        cfg = cfg.replace(remat=True)
    if shape.kind == "decode":
        cfg = cfg.replace(attn_chunk=8192)
    return cfg


def window_override(arch: str, shape: InputShape) -> Optional[int]:
    """The decode step's window: `SWA_WINDOW` for a full-attention arch at
    long_500k, else none."""
    return SWA_WINDOW if (shape.name == "long_500k"
                          and arch in LONG_SWA) else None


# ---------------------------------------------------------------------------
# Shapes on the meta device: the one-card counterparts of JAX's
# `models/inputs.{prefill,train}_batch_specs` and `decode_cache_specs`.
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, seq_len: int, batch: int,
                kind: str = "train", device="meta") -> dict:
    """The batch `models.inputs.make_batch` draws, as empty tensors: tokens
    (and labels for training) of the text length, and the front end's
    stub inputs."""
    shape = (batch, text_len(cfg, seq_len))
    out = {"tokens": torch.empty(shape, dtype=torch.int64, device=device)}
    if kind == "train":
        out["labels"] = torch.empty(shape, dtype=torch.int64, device=device)
    stub = {"vision_stub": ("patch_embeds", cfg.prefix_tokens),
            "audio_stub": ("frames", cfg.encoder_seq)}.get(cfg.frontend)
    if stub is not None:
        name, length = stub
        out[name] = torch.empty(batch, length, cfg.frontend_dim,
                                dtype=cfg.cdtype, device=device)
    return out


@contextlib.contextmanager
def meta_attention():
    """The attention kernels' wrappers run on CUDA or the CPU and refuse
    other devices; inside this context a ``meta`` tensor gets outputs of
    its shapes instead (nothing to launch: a meta tensor has no data), so
    that a step runs on the meta device.  Every other device goes to the
    wrappers as before."""
    fwd, bwd = fa._forward, fa.flash_attention_bwd

    def forward(q, k, v, causal, window, cap, scale, with_lse):
        if q.device.type != "meta":
            return fwd(q, k, v, causal, window, cap, scale, with_lse)
        B, H, Sq, _ = q.shape
        lse = (torch.empty((B, H, Sq), dtype=torch.float32, device="meta")
               if with_lse else None)
        return torch.empty_like(q), lse

    def backward(q, k, v, o, lse, do, **kw):
        if q.device.type != "meta":
            return bwd(q, k, v, o, lse, do, **kw)
        return tuple(torch.empty_like(x) for x in (q, k, v))

    fa._forward, fa.flash_attention_bwd = forward, backward
    try:
        yield
    finally:
        fa._forward, fa.flash_attention_bwd = fwd, bwd


def decode_cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """The decode caches of ``cache_len`` positions on the meta device: a
    one-token prefill's caches laid out by `serve.pad_caches` (an
    attention layer's window, or the windowed config's, is a ring of that
    many slots; recurrent layers keep their state)."""
    with meta_attention():
        caches = tfm.prefill(_meta_params(cfg),
                             batch_specs(cfg, 1, batch, "prefill"), cfg)[1]
    return pad_caches(caches, cfg, cache_len, 1)


@functools.lru_cache(maxsize=64)
def _meta_params(cfg: ArchConfig) -> dict:
    """The parameters on the meta device (a plan prices a configuration
    at several batches and depths)."""
    return tfm.init_params(0, cfg, device="meta")


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _unwindowed(cfg: ArchConfig) -> ArchConfig:
    """The configuration with every attention window removed: a prefill
    returns each layer's k, v at every position."""
    return cfg.replace(pattern=tuple(dataclasses.replace(s, window=0)
                                     for s in cfg.pattern))


def _layer_elems(cfg: ArchConfig, spec, tokens: int) -> float:
    """Elements a layer's forward holds at once for ``tokens`` positions:
    the residual stream and its norms, q, k, v and the attention output,
    and the mixer's or FFN's hidden tensors."""
    d = cfg.d_model
    n = 8 * d + (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.hd
    if spec.mixer == "mamba":
        n += 8 * cfg.d_inner
    elif spec.mixer in ("mlstm", "slstm"):
        n += 10 * d
    if spec.ffn == "moe":
        n += (cfg.top_k * cfg.capacity_factor * (d + 3 * cfg.d_ff_expert)
              + 2 * cfg.num_experts)
    elif spec.ffn == "dense":
        n += 3 * cfg.d_ff
    return float(tokens) * n


def _scan_bytes(cfg: ArchConfig, batch: int) -> float:
    """The chunked selective scan's doubling buffers: a chunk's (B, chunk,
    d_inner, state) f32 tensors, a few alive at once."""
    if not any(s.mixer == "mamba" for s in cfg.pattern):
        return 0.0
    return 6.0 * batch * cfg.ssm_chunk * cfg.d_inner * cfg.ssm_state * 4


def _leaf_terms(leaves) -> dict:
    """The two terms a single leaf sets, from ``(numel, dims,
    element_size)`` of each: ``init``, the f32 draw that drawing the
    parameters holds beside them (`layers.dense_init` draws a whole leaf
    in f32 and casts it; `layers.normal_init`, the MoE experts' leaves of
    four axes or more, at most 2^28 elements at a time); ``grad_leaf``,
    the largest leaf's bytes, which a training step's backward holds once
    more (autograd sums each period's gradient into the stacked leaf
    through a full-size tensor)."""
    return {"init": 4 * max(n if dims <= 3 else min(n, 1 << 28)
                            for n, dims, _ in leaves),
            "grad_leaf": max(n * size for n, _, size in leaves)}


def _leaves(cfg: ArchConfig) -> list:
    return [(x.numel(), x.dim(), x.element_size())
            for x in tree_leaves(_meta_params(cfg))]


def reckon(cfg: ArchConfig, shape: InputShape, microbatches: int = 1,
           window: Optional[int] = None) -> dict:
    """The bytes a step of ``cfg`` at ``shape`` holds on the card at its
    peak: counted on the meta device (params, caches) or reckoned from
    the shapes (activations, logits).  ``total`` is the larger of the
    step's sum and the parameters' draw (params and ``init``,
    `_leaf_terms`)."""
    P = _bytes(_meta_params(cfg))
    E = torch.empty((), dtype=cfg.cdtype).element_size()
    B, S, V = shape.global_batch, shape.seq_len, cfg.vocab_size
    out = {"params": P, "grads": 0, "cache": 0, "activations": 0.0,
           "logits": 0.0, **_leaf_terms(_leaves(cfg))}
    if shape.kind != "train":
        out["grad_leaf"] = 0
    if shape.kind == "train":
        Bm = max(B // microbatches, 1)
        T = Bm * S
        out["grads"] = P if microbatches == 1 else P + 2 * P
        period = sum(_layer_elems(cfg, s, T) for s in cfg.pattern)
        out["activations"] = (cfg.num_periods * T * cfg.d_model * E
                              + period * E + _scan_bytes(cfg, Bm))
        # bf16 logits, their f32 copy and log-softmax, the f32 gradient
        # and its bf16 cast.
        out["logits"] = float(T) * V * 16
    elif shape.kind == "prefill":
        out["cache"] = _bytes(decode_cache_specs(_unwindowed(cfg), B, S))
        T = B * S
        out["activations"] = (max(_layer_elems(cfg, s, T)
                                  for s in cfg.pattern) * E
                              + _scan_bytes(cfg, B))
        out["logits"] = float(B) * V * 4 * 2
    else:
        run_cfg = ds.windowed_config(cfg, window)
        caches = decode_cache_specs(run_cfg, B, S)
        out["cache"] = _bytes(caches)
        # `decode_attention_delta` reads a layer's cache in f32 (k and v)
        # and holds its scores.
        widest = 0.0
        for i, spec in enumerate(run_cfg.pattern):
            c = caches[f"b{i}"]["mixer"]
            if spec.mixer == "attn":
                slots = c["k"].shape[2]
                widest = max(widest, B * slots * (
                    2 * cfg.num_kv_heads * cfg.hd + 3 * cfg.num_heads) * 4)
        out["activations"] = widest + max(
            _layer_elems(cfg, s, B) for s in cfg.pattern) * 4
        out["logits"] = float(B) * V * 4 * 2
    return _with_total(out)


def _with_total(terms: dict) -> dict:
    terms = {k: v for k, v in terms.items() if k != "total"}
    terms["total"] = max(terms["params"] + terms["grads"]
                         + terms["grad_leaf"] + terms["cache"]
                         + terms["activations"] + terms["logits"],
                         terms["params"] + terms["init"])
    return terms


def _batches(global_batch: int):
    b = global_batch
    while True:
        yield b
        if b == 1:
            return
        b = max(b // 2, 1)


def _reckon_at(cfg: ArchConfig, shape: InputShape, periods,
               window: Optional[int]) -> tuple:
    """``(M, [bytes at each of periods])`` of ``cfg`` cut to each period
    count, from `reckon` at one and two periods: every term is linear in
    the periods (the embeddings, the logits and one period's working set
    are the constant; the stacked leaves grow with them), so two meta
    builds price any depth."""
    deepest = cfg.replace(num_layers=max(periods) * len(cfg.pattern))
    M = (ds.auto_microbatches(deepest, shape) if shape.kind == "train"
         else 1)
    cfgs = [cfg.replace(num_layers=n * len(cfg.pattern)) for n in (1, 2)]
    one, two = (reckon(c, shape, M, window) for c in cfgs)
    # A leaf's size is linear in the periods, the largest leaf is not.
    l1, l2 = (_leaves(c) for c in cfgs)
    out = []
    for p in periods:
        terms = {k: one[k] + (p - 1) * (two[k] - one[k]) for k in one}
        lp = [(a[0] + (p - 1) * (b[0] - a[0]), a[1], a[2])
              for a, b in zip(l1, l2)]
        leaf = _leaf_terms(lp)
        terms["init"] = leaf["init"]
        if shape.kind == "train":
            terms["grad_leaf"] = leaf["grad_leaf"]
        out.append(_with_total(terms))
    return M, out


def plan(arch: str, shape_name: str, *, card_bytes: float = CARD_BYTES,
         margin: float = MARGIN, max_batch: Optional[int] = None,
         cfg: Optional[ArchConfig] = None) -> dict:
    """The row's plan on the meta device: ``status`` ``ok`` with the cut
    that fits ``card_bytes`` less ``margin`` of it, ``does_not_fit`` with
    the bytes at batch 1 and one period, or ``skip`` with JAX's reason.
    ``max_batch``: a further cap on the batch (a run's time), recorded
    with the other cuts.  ``cfg``: the configuration to plan in place of
    the registered one (the tests' reduced ones)."""
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "status": "skip"}
    if shape.name == "long_500k" and arch in LONG_SKIP:
        rec["reason"] = LONG_SKIP[arch]
        return rec
    base = cfg if cfg is not None else prepare_cfg(arch, shape)
    window = window_override(arch, shape) if shape.kind == "decode" else None
    rec["window_override"] = window
    budget = card_bytes * (1.0 - margin)
    cap = shape.global_batch if max_batch is None else min(
        max_batch, shape.global_batch)

    def shaped(B):
        return InputShape(shape.name, shape.seq_len, B, shape.kind)

    periods = base.num_periods
    for B in _batches(cap):
        M, (bytes_,) = _reckon_at(base, shaped(B), [periods], window)
        if bytes_["total"] <= budget:
            break
    else:
        # Batch 1: the most whole periods that fit, one at least.
        depths = list(range(base.num_periods - 1, 0, -1)) or [1]
        M, priced = _reckon_at(base, shaped(1), depths, window)
        for periods, bytes_ in zip(depths, priced):
            if bytes_["total"] <= budget:
                break
    layers = periods * len(base.pattern)
    rec.update(global_batch=B, num_layers=layers, seq_len=shape.seq_len,
               bytes=bytes_, budget_bytes=budget, card_bytes=card_bytes,
               reduced=_cuts(shape, base, B, layers))
    if bytes_["total"] > budget:
        rec["status"] = "does_not_fit"
        return rec
    rec.update(status="ok", microbatches=M)
    return rec


def _cuts(shape: InputShape, cfg: ArchConfig, B: int, layers: int) -> dict:
    cuts = {}
    if B != shape.global_batch:
        cuts["global_batch"] = f"{shape.global_batch}→{B}"
    if layers != cfg.num_layers:
        cuts["num_layers"] = f"{cfg.num_layers}→{layers}"
    return cuts


def planned_config(rec: dict, cfg: Optional[ArchConfig] = None):
    """(cfg, shape) of a planned row, its cuts applied."""
    shape = INPUT_SHAPES[rec["shape"]]
    base = cfg if cfg is not None else prepare_cfg(rec["arch"], shape)
    return (base.replace(num_layers=rec["num_layers"]),
            InputShape(shape.name, shape.seq_len, rec["global_batch"],
                       shape.kind))


def build_step(arch: str, shape: InputShape, cfg: ArchConfig, *,
               device, seed: int = 0, microbatches: int = 1,
               params: Optional[dict] = None):
    """The row's step and its inputs on ``device``, through the port's
    builders where JAX's `build_step` calls its own: ``(run, meta)``,
    ``run()`` one step.

    Training: `dist_steps.make_train_step` with donation (JAX donates the
    params), SGD, the FL plan's weights and channel noise; JAX's plan has
    a client per data-parallel rank, and one card has one, so the plan is
    the train phase's K = 4, C = 3 at 40 dB.  Prefill:
    `make_prefill_step`.  Decode: `make_decode_step` with
    ``window_override`` at long_500k for the full-attention archs, one
    token at the last position of a ``seq_len``-position cache drawn at
    random (a ring of the window's slots where windowed).  ``params``:
    the caller's parameters, else drawn from ``seed``."""
    from repro_torch.dist.fl_integration import make_fl_plan
    from repro_torch.models.inputs import make_batch
    from repro_torch.optim import sgd

    B, S = shape.global_batch, shape.seq_len
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind}
    if params is None:
        params = tfm.init_params(seed, cfg, device=device)
    if shape.kind == "train":
        fl = make_fl_plan(4, 3, 0, snr_db=40.0, device=device)
        fn = ds.make_train_step(cfg, shape, plan=fl, lr=1e-3,
                                microbatches=microbatches, donate=True)
        batch = make_batch(seed + 1, cfg, S, B, kind="train", device=device)
        state = {"opt": sgd(1e-3).init(params)}
        noise = torch.Generator(device).manual_seed(seed + 2)
        meta["microbatches"] = microbatches

        def run():
            _, state["opt"], m = fn(params, state["opt"], batch, noise)
            return m["loss"]
        return run, meta
    if shape.kind == "prefill":
        fn = ds.make_prefill_step(cfg, shape)
        batch = make_batch(seed + 1, cfg, S, B, kind="prefill",
                           device=device)

        def run():
            return fn(params, batch)[0]
        return run, meta
    ov = window_override(arch, shape)
    meta["window_override"] = ov
    fn = ds.make_decode_step(cfg, shape, window_override=ov)
    gen = torch.Generator(device).manual_seed(seed + 1)
    caches = _random_caches(decode_cache_specs(fn.cfg, B, S), gen, device)
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=device)
    enc_kv = None
    if cfg.frontend == "audio_stub":
        audio = make_batch(seed + 2, cfg, 1, B, kind="prefill",
                           device=device)
        enc_kv = tfm.encoder_kv(tfm._first_cross_params(params, cfg),
                                tfm._encode_audio(params, audio, cfg), cfg)

    def run():
        return fn(params, token, caches, S - 1, enc_kv=enc_kv)[0]
    return run, meta


def _random_caches(specs: dict, gen, device) -> dict:
    """Unit normals in each cache leaf's shape and dtype, drawn in that
    dtype (an f32 draw cast down would hold twice a bf16 cache's bytes
    at once)."""
    if isinstance(specs, dict):
        return {k: _random_caches(v, gen, device) for k, v in specs.items()}
    return torch.randn(specs.shape, generator=gen, device=device,
                       dtype=specs.dtype)


def run_one(arch: str, shape_name: str, *, device="cuda", reps: int = 2,
            max_batch: Optional[int] = None,
            card_bytes: Optional[float] = None,
            cfg: Optional[ArchConfig] = None,
            params: Optional[dict] = None) -> dict:
    """Plan the row, then run it on ``device``: one warm-up and ``reps``
    timed steps, each behind a synchronize; the peak memory
    (``max_memory_allocated`` after a reset, the params and inputs
    included) against the plan's; the output finite; the roofline.
    ``cfg``: as `plan`'s (the tests run reduced configurations on the
    CPU, where no peak is measured).  ``params``: the planned
    configuration's parameters, drawn by the caller before the peak's
    reset (else `build_step` draws them, inside the peak)."""
    from repro_torch.launch import roofline

    if card_bytes is None:
        card_bytes = (torch.cuda.get_device_properties(0).total_memory
                      if torch.device(device).type == "cuda" else CARD_BYTES)
    rec = plan(arch, shape_name, card_bytes=card_bytes,
               max_batch=max_batch, cfg=cfg)
    if rec["status"] != "ok":
        return rec
    cfg, shape = planned_config(rec, cfg)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    try:
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        run, meta = build_step(arch, shape, cfg, device=device,
                               microbatches=rec["microbatches"],
                               params=params)
        rec.update(meta)
        _sync(cuda)
        setup_s = time.perf_counter() - t0
        out = run()
        _sync(cuda)
        warm_s = time.perf_counter() - t0 - setup_s
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            out = run()
            _sync(cuda)
            times.append(time.perf_counter() - t1)
        finite = bool(torch.isfinite(out.float()).all())
        rec["run"] = {"setup_s": setup_s, "warmup_s": warm_s,
                      "step_s": sorted(times)[len(times) // 2],
                      "steps_s": times, "finite": finite,
                      "peak_bytes": (torch.cuda.max_memory_allocated()
                                     if cuda else None)}
        rec["roofline"] = roofline.analyse(rec, cfg, shape)
        if not finite:
            rec["status"] = "fail"
            rec["error"] = "non-finite output"
    except Exception as e:  # noqa: BLE001 — the dry run reports failures
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        run = out = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return rec


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None, nargs="*")
    ap.add_argument("--shape", default=None, nargs="*")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--meta-only", action="store_true",
                    help="plan every row on the meta device, run none")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else args.arch
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else args.shape)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else []
    done = {(r["arch"], r["shape"])
            for r in results if r["status"] in ("ok", "skip", "does_not_fit")
            and (args.meta_only or r["status"] != "ok" or "run" in r)}
    for arch in archs:
        for shape_name in shapes:
            key = (arch, shape_name)
            if key in done:
                continue
            print(f"[dryrun] {arch} × {shape_name} ...", flush=True)
            if args.meta_only:
                rec = plan(arch, shape_name, max_batch=args.max_batch)
            else:
                rec = run_one(arch, shape_name, device=args.device,
                              reps=args.reps, max_batch=args.max_batch)
            run = rec.get("run", {})
            print(f"  -> {rec['status']} cut={rec.get('reduced', {})} "
                  f"plan={rec.get('bytes', {}).get('total', 0) / 1e9:.2f} GB"
                  f" peak={(run.get('peak_bytes') or 0) / 1e9:.2f} GB "
                  f"step={run.get('step_s', 0):.4g}s "
                  f"{rec.get('error', '')}", flush=True)
            results = [r for r in results
                       if (r["arch"], r["shape"]) != key]
            results.append(rec)
            out_path.write_text(json.dumps(results, indent=1))
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skip", "does_not_fit", "fail")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skip']} skip, "
          f"{n['does_not_fit']} do not fit, {n['fail']} fail")
    sys.exit(1 if n["fail"] else 0)


if __name__ == "__main__":
    main()
