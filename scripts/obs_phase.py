"""Build the FL kernels and run ``chip_smoke.py``'s obs phase alone:
telemetry, checkpoints and the live stream at full width, about two
minutes on one H100: ``python3 scripts/obs_phase.py``.  Run from the
checkout's root."""
import subprocess
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cwfl_round as kmod  # noqa: E402
from repro_torch.kernels import ota_aggregate as omod  # noqa: E402
from repro_torch.kernels._build import build  # noqa: E402

print(sys.version, torch.__version__, torch.version.cuda, flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
cs.CARD.append(smi)
print(smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
build([kmod.SOURCE, omod.SOURCE])
kmod._library()
omod._library()
print("build_s", time.perf_counter() - t0, flush=True)
print(cs.obs_phase(kmod, omod), flush=True)
