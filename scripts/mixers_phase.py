"""Build the attention kernels and run ``chip_smoke.py``'s mixers phase
alone, or some of its parts:

    python3 scripts/mixers_phase.py [--parts fa reference full faults]
                                    [--configs NAME ...]

``fa``: the flash kernels against their plain version at the mixers'
``FA_SHAPES`` rows (Qwen3-MoE's, Jamba's and InternVL2's prefills, Kimi
K2's head dim 112 through the padding, whisper's encoder and its
cross-attention in the prefill and in a decode step); ``reference``: each
reduced configuration's greedy decoding on the card against the CPU;
``full``: each configuration served at full width (``MIXER_RUNS``);
``faults`` (with ``full``): the gate's reading on the same model when the
decoded path is broken on purpose, at run time: the cache update after
decode step j (0, 8, 14) skipped, so that every layer forgets that
token's keys, values or state.
``--configs`` picks configurations of ``MIXER_RUNS`` (default: all).  Run
from the checkout's root; needs one CUDA device.
"""
import argparse
import gc
import subprocess
import sys
import time
import traceback

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import build, library_path  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

PARTS = ("fa", "reference", "full", "faults")
FAULT_STEPS = (0, 8, 14)
MIXER_SHAPES = ("qwen3_moe_prefill_bf16", "kimi_k2_d112_bf16",
                "jamba_prefill_bf16", "internvl2_prefill_f32",
                "whisper_encoder", "whisper_cross", "whisper_cross_decode")
NAMES = list(dict.fromkeys(run[0] for run in cs.MIXER_RUNS))

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
ap.add_argument("--configs", nargs="*", default=NAMES, choices=NAMES)
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("mixers_phase.py needs a CUDA device; none found")
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
build(list(fa.SOURCES))
print("build_s", time.perf_counter() - t0, flush=True)
for source in fa.SOURCES:
    log = library_path(source).with_suffix(".log").read_text()
    print(source.name, [ln.strip() for ln in log.splitlines()
                        if any(w in ln for w in ("registers", "spill",
                                                 "arning"))], flush=True)


def fault_readings(params, batch, cfg, P) -> dict:
    """For each of FAULT_STEPS, the gate (`chip_smoke.decode_gate`) of a
    ``greedy_decode`` that skips that step's cache update: the largest
    absolute difference and the relative L2 distance of each row, routed
    as the decoded path and free."""
    from repro_torch.training import serve

    apply, out = serve.apply_cache_deltas, {}
    for step in FAULT_STEPS:
        calls = []

        def faulty(caches, deltas, pos, cfg_, step=step, calls=calls):
            calls.append(pos)
            return (caches if len(calls) - 1 == step
                    else apply(caches, deltas, pos, cfg_))

        serve.apply_cache_deltas = faulty
        try:
            gate = cs.decode_gate(params, batch, cfg, P)
        finally:
            serve.apply_cache_deltas = apply
        out[f"lost_update_step_{step}"] = {
            key: gate[key] for key in ("max_abs", "rel_l2", "free_max_abs",
                                       "free_rel_l2")}
    return out


failed = []
if "fa" in args.parts:
    try:
        cs.flash_kernel_phase(fa, flash_attention_ref, shapes=[
            s for s in cs.FA_SHAPES if s[0] in MIXER_SHAPES])
    except Exception:   # noqa: BLE001 (reported, then the exit code)
        traceback.print_exc()
        failed.append("fa")
done = set()
for name, dtype, layers, B, seq in cs.MIXER_RUNS:
    if name not in args.configs:
        continue
    # A part's failure is reported and the others still run; the script
    # exits non-zero if any failed.
    try:
        if "reference" in args.parts and name not in done:
            done.add(name)
            cs.mixer_reference_run(fa, name)
        if "full" in args.parts:
            cs.mixer_full_width_run(
                fa, name, dtype, layers, B, seq,
                probe=fault_readings if "faults" in args.parts else None)
    except Exception:   # noqa: BLE001 (reported, then the exit code)
        traceback.print_exc()
        failed.append(name)
        gc.collect()
        torch.cuda.empty_cache()
print(smi, flush=True)
print("seconds", time.perf_counter() - t0, flush=True)
if failed:
    raise SystemExit(f"failed: {failed}")
