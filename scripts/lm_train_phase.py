"""Build the attention kernels (and the round kernel) and run
``chip_smoke.py``'s lm_train phase alone, or some of its parts:

    python3 scripts/lm_train_phase.py [--parts bwd reference qwen twin]

``bwd``: the attention backward kernel against its plain version at every
listed shape; ``reference``: the reduced Gemma-2's train steps on the card
against the CPU; ``qwen``: Qwen2.5-3B training at full width; ``twin``:
``examples/train_lm_cwfl_torch.py``.  Run from the checkout's root; needs
one CUDA device.
"""
import argparse
import subprocess
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cwfl_round as kmod  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import build, library_path  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)

PARTS = ("bwd", "reference", "qwen", "twin")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("lm_train_phase.py needs a CUDA device; none found")
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
sources = [kmod.SOURCE, *fa.SOURCES, fa.SOURCE_BWD]
build(sources)
print("build_s", time.perf_counter() - t0, flush=True)
for source in sources:
    log = library_path(source).with_suffix(".log").read_text()
    print(source.name, [ln.strip() for ln in log.splitlines()
                        if any(w in ln for w in ("registers", "spill",
                                                 "arning"))], flush=True)
rows = []
if "bwd" in args.parts:
    rows += cs.fa_bwd_kernel_phase(fa, flash_attention_ref,
                                   flash_attention_bwd_ref)
if "reference" in args.parts:
    print(cs.lm_train_reference_phase(fa, kmod), flush=True)
if "qwen" in args.parts:
    print(cs.lm_qwen_phase(fa), flush=True)
if "twin" in args.parts:
    cs.lm_twin_phase()
cs.emit({"kernels": rows})
