"""Time compiled ``flex_attention``'s backward beside the port's attention
backward kernel at Gemma-2 9B's layer shapes with the softcap (cap 50),
where SDPA, which has no softcap, cannot serve as the yardstick:

    python3 scripts/flex_bwd_yardstick.py [--shapes LABEL ...]

For each of ``chip_smoke.py``'s ``BWD_SHAPES`` rows named (default: the
global and local Gemma-2 layers, f32 and bf16): the kernel's backward
(device ms, on the forward kernel's o and lse), and ``flex_attention``
compiled with the softcap as its ``score_mod``, the causal/window band as
its block mask and GQA: its forward, and its forward and backward through
``torch.autograd.grad`` (device ms; the backward is the difference), its
gradients against the plain backward's.  If the compiler refuses a shape
(the backward's tiles at D = 256), the error is printed and the script
goes on.  Run from the checkout's root; needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import build  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: E402

DEFAULT = ("gemma2_global", "gemma2_local", "gemma2_global_bf16",
           "gemma2_local_bf16")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--shapes", nargs="*", default=list(DEFAULT),
                choices=[s[0] for s in cs.BWD_SHAPES])
args = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("flex_bwd_yardstick.py needs a CUDA device; none found")
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", "build/inductor")
os.environ.setdefault("TRITON_CACHE_DIR", "build/triton")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
cs.CARD.append(smi)
print(sys.version, torch.__version__, torch.version.cuda, smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build([*fa.SOURCES, fa.SOURCE_BWD])

import torch._inductor.config as inductor_config  # noqa: E402
from torch.nn.attention.flex_attention import (  # noqa: E402
    create_block_mask, flex_attention)

inductor_config.compile_threads = 1     # no pool of workers left behind
compiled = torch.compile(flex_attention, dynamic=False)

for label, B, H, KV, S, D, dtype, window, cap in cs.BWD_SHAPES:
    if label not in args.shapes:
        continue
    g = torch.Generator(cs.DEVICE).manual_seed(S + D + window + 1)
    q = (4 * torch.randn(B, H, S, D, generator=g, device=cs.DEVICE)).to(
        dtype)
    k = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
    v = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
    do = torch.randn(B, H, S, D, generator=g, device=cs.DEVICE).to(dtype)
    mode = {"causal": True, "window": window, "cap": cap,
            "scale": D ** -0.5}
    o, lse = fa._forward(q, k, v, True, window, cap, D ** -0.5, True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **mode)
    line = {"phase": "flex_bwd_yardstick", "shape": label, "B": B, "H": H,
            "KV": KV, "S": S, "D": D, "dtype": str(dtype), "window": window,
            "cap": cap, "card": smi,
            "kernel_bwd_ms": cs.device_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, **mode), 5)}

    def band(b, h, qi, ki):
        keep = ki <= qi
        return keep & (ki > qi - window) if window > 0 else keep

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    kw = {"block_mask": create_block_mask(band, None, None, S, S,
                                          device=cs.DEVICE),
          "score_mod": softcap, "enable_gqa": True}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    t0 = time.perf_counter()
    try:
        forward = lambda: compiled(qg, kg, vg, **kw)   # noqa: E731
        both = lambda: torch.autograd.grad(            # noqa: E731
            forward(), (qg, kg, vg), do)
        got = both()
        torch.cuda.synchronize()
    except Exception as exc:   # noqa: BLE001 (the yardstick only; reported)
        line["library_error"] = repr(exc)[:2000]
        line["compile_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        continue
    line["compile_s"] = time.perf_counter() - t0
    line["library_rel_err"] = {
        n: cs.rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                               want)}
    del got
    line["library_fwd_ms"] = cs.device_ms(forward, 5)
    line["library_fwd_bwd_ms"] = cs.device_ms(both, 5)
    line["library_bwd_ms"] = (line["library_fwd_bwd_ms"]
                              - line["library_fwd_ms"])
    print(json.dumps(line), flush=True)
    del q, k, v, do, o, lse, want, qg, kg, vg
    torch.cuda.empty_cache()
print(smi, flush=True)
