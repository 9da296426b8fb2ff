"""Build the attention kernels and run ``chip_smoke.py``'s training of the
other mixers, front ends and dense models alone, or some of its parts:

    python3 scripts/train_phase.py [--parts bwd reference full twin]
                                   [--configs NAME ...]

``bwd``: the attention backward kernel against its plain version at the
training geometries ``BWD_SHAPES`` gained for them (G = 16, Kimi K2's head
dim 112 through the pad, Jamba's, InternVL2's and phi4-mini's layers,
whisper's encoder without a mask and its cross-attention on 1,500 frames);
``reference``: each reduced configuration's shard step on the card
against the CPU, remat and donation bitwise (``TRAIN_REDUCED``: those of
``TRAIN_RUNS``, Kimi K2, also at its head dim of 112, and llama3-405b);
``full``: three steps at the published width (``TRAIN_RUNS``); ``twin``:
``examples/serve_decode_torch.py`` with a serving-time window, card
against CPU.  ``--configs`` picks configurations (default: all).  Run from
the checkout's root; needs one CUDA device.
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
from repro_torch.kernels._build import build  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)

PARTS = ("bwd", "reference", "full", "twin")
NAMES = list(dict.fromkeys(name for name, _ in cs.TRAIN_REDUCED))
BWD_ROWS = ("qwen3_moe_bf16", "kimi_k2_d112_bf16", "jamba_bf16",
            "internvl2_bf16", "whisper_encoder_bf16", "whisper_cross_bf16",
            "phi4_mini_bf16")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
ap.add_argument("--configs", nargs="*", default=NAMES, choices=NAMES)
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("train_phase.py needs a CUDA device; none found")
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
build([*fa.SOURCES, fa.SOURCE_BWD])
print("build_s", time.perf_counter() - t0, flush=True)
failed = []


def attempt(label, fn, *fn_args):
    """Run one part; a failure is printed and the next part runs."""
    try:
        fn(*fn_args)
    except Exception:   # noqa: BLE001 - report every part's fault
        traceback.print_exc()
        failed.append(label)
        gc.collect()
        torch.cuda.empty_cache()


if "bwd" in args.parts:
    attempt("bwd", cs.fa_bwd_kernel_phase, fa, flash_attention_ref,
            flash_attention_bwd_ref,
            [r for r in cs.BWD_SHAPES if r[0] in BWD_ROWS])
if "reference" in args.parts:
    for name, head_dim in cs.TRAIN_REDUCED:
        if name in args.configs:
            attempt(f"{name} reference", cs.train_reference_run, fa, name,
                    head_dim)
if "full" in args.parts:
    for name, *run in cs.TRAIN_RUNS:
        if name in args.configs:
            attempt(f"{name} full", cs.train_full_width_run, fa, name, *run)
if "twin" in args.parts:
    attempt("twin", cs.serve_twin_phase, fa)
print("seconds", time.perf_counter() - t0, "failed", failed, flush=True)
sys.exit(1 if failed else 0)
