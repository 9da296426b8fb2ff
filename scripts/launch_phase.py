"""Build the kernels and run ``chip_smoke.py``'s one-card dry-run phase
(`repro_torch.launch`) alone, or some of its parts, and optionally the
whole dry-run matrix:

    python3 scripts/launch_phase.py [--parts plan kernel prefill decode
                                     long reference literal]
                                    [--matrix] [--archs NAME ...]
                                    [--max-batch N] [--out PATH]

``plan``: all 40 (arch × input shape) rows planned on the meta device;
``kernel``: kernel 4b at Qwen2.5-3B's 32,768-row prefill geometry against
its plain version in query chunks, timed beside SDPA; ``prefill``:
qwen2.5-3b × prefill_32k at whole depth; ``decode``: gemma2-9b ×
decode_32k at whole depth and its gate; ``long``: the long_500k rows of
phi4-mini (windowed), Jamba and Gemma-2 (native); ``reference``: the
decode attention at 524,288 positions against a plain f32 computation
and a reduced windowed decode far past its window against the CPU;
``literal``: a literal-weight CWFL round at MNIST width through kernel 1
against the CPU.  ``--matrix`` then runs `repro_torch.launch.dryrun` over
``--archs`` (default all) and every input shape, resumably, into
``--out`` (default ``results_torch/dryrun.json``).  Run from the
checkout's root; needs one CUDA device.
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
from repro_torch.kernels import cwfl_round as kmod  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import build  # noqa: E402

PARTS = ("plan", "kernel", "prefill", "decode", "long", "reference",
         "literal")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
ap.add_argument("--matrix", action="store_true")
ap.add_argument("--archs", nargs="*", default=None)
ap.add_argument("--shapes", nargs="*", default=None)
ap.add_argument("--max-batch", type=int, default=None)
ap.add_argument("--out", default="results_torch/dryrun.json")
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("launch_phase.py needs a CUDA device; none found")
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
build([kmod.SOURCE, *fa.SOURCES])
print("build_s", time.perf_counter() - t0, flush=True)
failed = []


def attempt(label, fn, *fn_args, **kw):
    """Run one part; a failure is printed and the next part runs."""
    t = time.perf_counter()
    try:
        fn(*fn_args, **kw)
    except Exception:   # noqa: BLE001 - report every part's fault
        traceback.print_exc()
        failed.append(label)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] {time.perf_counter() - t:.1f} s", flush=True)


if "plan" in args.parts:
    attempt("plan", cs.launch_plan_phase)
if "kernel" in args.parts:
    attempt("kernel", cs.launch_kernel_32k, fa)
if "prefill" in args.parts:
    attempt("prefill", cs.launch_run, fa, "qwen2.5-3b", "prefill_32k",
            max_batch=cs.LAUNCH_PREFILL_BATCH)
if "decode" in args.parts:
    attempt("decode", cs.gemma_decode_32k, fa)
if "long" in args.parts:
    for arch in ("phi4-mini-3.8b", "jamba-v0.1-52b", "gemma2-9b"):
        attempt(f"long {arch}", cs.launch_run, fa, arch, "long_500k")
if "reference" in args.parts:
    attempt("decode_attention_524k", cs.decode_attention_524k)
    attempt("windowed_decode", cs.windowed_decode_reference)
if "literal" in args.parts:
    attempt("literal", cs.literal_weight_phase, kmod)
if args.matrix:
    from repro_torch.launch import dryrun
    argv = ["--out", args.out, "--reps", "2"]
    if args.archs:
        argv += ["--arch", *args.archs]
    if args.shapes:
        argv += ["--shape", *args.shapes]
    if args.max_batch:
        argv += ["--max-batch", str(args.max_batch)]
    try:
        dryrun.main(argv)
    except SystemExit as e:
        if e.code:
            failed.append("matrix")
print(cs.CARD[0], flush=True)
print({"failed": failed}, flush=True)
sys.exit(1 if failed else 0)
