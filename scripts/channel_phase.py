"""Build the channel kernel and run ``chip_smoke.py``'s channel phases
alone, or some of them:

    python3 scripts/channel_phase.py [--parts kernel tie churn]

``kernel``: ``csrc/channel_view.cu`` bitwise against its plain version on
the card and the CPU (a 10-round cluster-churn process at K = 50, one
trajectory and a stack of 8), timed beside its bounds; ``tie``: the
cluster-head tie at JAX's topology seed 19, K = 8, card and CPU against
JAX's heads in both election orders; ``churn``: the cluster-churn run at
K = 50, one kernel launch a round and none in paper-static, and the
scan's rounds/s.  Run from the checkout's root; needs one CUDA device.
"""
import argparse
import subprocess
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import channel_view as cmod  # noqa: E402
from repro_torch.kernels import cwfl_round as kmod  # noqa: E402
from repro_torch.kernels._build import build  # noqa: E402

PARTS = ("kernel", "tie", "churn")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("channel_phase.py needs a CUDA device; none found")
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
build([cmod.SOURCE, kmod.SOURCE])
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
if "kernel" in args.parts:
    cs.emit({"row": cs.channel_kernel_phase(cmod)})
if "tie" in args.parts:
    cs.tie_phase()
if "churn" in args.parts:
    cs.churn_phase(cmod, kmod)
print(smi, flush=True)
