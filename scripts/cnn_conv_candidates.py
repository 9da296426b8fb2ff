#!/usr/bin/env python3
"""Time the ways to run the CIFAR CNN's K clients' convolutions together.

    python3 scripts/cnn_conv_candidates.py [--reps N]

One local step of the paper's CIFAR protocol at full width — K=27 clients,
a batch of 32 images of 32×32×3 each, the CNN of
`repro_torch.models.make_cifar_cnn` (d = 698,250), the NLL of every
client summed and differentiated — with the stacked convolutions computed
by each candidate in turn:

* ``grouped``: one ``F.conv2d`` a layer with ``groups=K`` on
  (B, K·C_in, H, W), input and weights channels-last — the model's own
  path;
* ``grouped_nchw``: the same in contiguous NCHW;
* ``grouped_cudnn_benchmark``: the same with cuDNN's autotuner on;
* ``grouped_deterministic``: the same held to cuDNN's deterministic
  algorithms (``torch.backends.cudnn.deterministic``), as the engine's
  runs are;
* ``vmap``: ``torch.func.vmap`` of ``F.conv2d`` over the clients;
* ``im2col_bmm``: ``F.unfold`` and one ``torch.bmm`` over the clients.

Each candidate's log-probabilities and gradients are held against the
model's own path computed in float64 on the card: the relative error in
norm of the log-probabilities and of each gradient leaf (the largest of
them).  ``f32_accurate``: the log-probabilities within 1e-5 (f32 sums
reach about 1e-6, TF32's 10-bit mantissa about 1e-3) and the gradients
within 1e-2 (a ReLU or max-pool tie that rounds the other way in f32
routes a gradient elsewhere, so every f32 path is about 1e-3 off), and
its forward + backward step is timed with CUDA events (median of
``--reps``, after warm-up), TF32 off as the reference demands.
``replays_itself``: two steps on the same inputs give the same bits.  One JSON
line a candidate, then the fastest candidate that is f32-accurate, then
the card's name and power limit.  Needs a CUDA device.
"""
import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
K, B, HW = 27, 32, (32, 32, 3)


def _pool(y):
    return F.max_pool2d(torch.relu(y), 2)


def conv_nchw(x, p):
    K_, kh, kw, c_in, c_out = p["w"].shape
    w = p["w"].permute(0, 4, 3, 1, 2).reshape(K_ * c_out, c_in, kh, kw)
    return _pool(F.conv2d(x.contiguous(), w.contiguous(), p["b"].reshape(-1),
                          padding=1, groups=K_))


def conv_vmap(x, p):
    K_, kh, kw, c_in, c_out = p["w"].shape
    Bn, _, H, W = x.shape
    xk = x.reshape(Bn, K_, c_in, H, W).transpose(0, 1)
    y = torch.func.vmap(lambda xi, wi, bi: F.conv2d(xi, wi, bi, padding=1))(
        xk, p["w"].permute(0, 4, 3, 1, 2), p["b"])
    return _pool(y.transpose(0, 1).reshape(Bn, K_ * c_out, H, W))


def conv_im2col_bmm(x, p):
    K_, kh, kw, c_in, c_out = p["w"].shape
    Bn, _, H, W = x.shape
    cols = F.unfold(x, 3, padding=1)                 # (B, K·C_in·9, H·W)
    cols = cols.reshape(Bn, K_, c_in * 9, H * W).permute(1, 0, 3, 2)
    cols = cols.reshape(K_, Bn * H * W, c_in * 9)
    w = p["w"].permute(0, 3, 1, 2, 4).reshape(K_, c_in * 9, c_out)
    y = torch.baddbmm(p["b"][:, None, :], cols, w)   # (K, B·H·W, C_out)
    y = y.reshape(K_, Bn, H, W, c_out).permute(1, 0, 4, 2, 3)
    return _pool(y.reshape(Bn, K_ * c_out, H, W))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cnn_conv_candidates.py needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import small
    from repro_torch.utils import tree_map
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    init, apply = small.make_cifar_cnn(HW)
    gen = torch.Generator(dev).manual_seed(0)
    params = tree_map(lambda t: t.expand((K,) + t.shape).clone(), init(gen))
    params = tree_map(lambda t: t + 0.01 * torch.randn(
        t.shape, generator=gen, device=dev), params)
    x = torch.randn(K, B, *HW, generator=gen, device=dev)
    y = torch.randint(10, (K, B), generator=gen, device=dev)
    own = small._conv_relu_pool

    @contextlib.contextmanager
    def candidate(name):
        cudnn = torch.backends.cudnn
        saved = cudnn.benchmark, cudnn.deterministic
        conv = {"vmap": conv_vmap, "im2col_bmm": conv_im2col_bmm,
                "grouped_nchw": conv_nchw}.get(name, own)
        small._conv_relu_pool = conv
        cudnn.benchmark = name == "grouped_cudnn_benchmark"
        cudnn.deterministic = name == "grouped_deterministic"
        try:
            yield
        finally:
            small._conv_relu_pool = own
            cudnn.benchmark, cudnn.deterministic = saved

    flat, treedef = tree_flatten(params)

    def step(x):
        leaves = [t.detach().requires_grad_(True) for t in flat]
        logp = apply(tree_unflatten(treedef, leaves), x)
        loss = small.nll_loss(logp, y).sum()
        return logp.detach(), torch.autograd.grad(loss, leaves)

    # The truth: the model's own path in float64 on the card.
    flat64 = [t.double() for t in flat]
    leaves = [t.requires_grad_(True) for t in flat64]
    ref_logp = apply(tree_unflatten(treedef, leaves), x.double())
    ref_grads = torch.autograd.grad(small.nll_loss(ref_logp, y).sum(),
                                    leaves)
    ref_logp = ref_logp.detach()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = ("grouped", "grouped_deterministic", "grouped_nchw",
             "grouped_cudnn_benchmark", "vmap", "im2col_bmm")
    lines = []
    for name in names:
        with candidate(name):
            logp, grads = step(x)
            err = max(float(torch.linalg.vector_norm(g.double() - r)
                            / torch.linalg.vector_norm(r))
                      for g, r in zip(grads, ref_grads))
            again = step(x)[1]
            replays = all(torch.equal(a, b) for a, b in zip(grads, again))
            step(x)
            times = []
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        logp_err = float(torch.linalg.vector_norm(logp.double() - ref_logp)
                         / torch.linalg.vector_norm(ref_logp))
        line = {"candidate": name, "K": K, "B": B, "hw": HW,
                "step_ms_median": sorted(times)[len(times) // 2],
                "step_ms_min": min(times), "reps": args.reps,
                "logp_rel_err": logp_err, "grad_rel_err": err,
                "replays_itself": replays,
                "f32_accurate": logp_err <= 1e-5 and err <= 1e-2,
                "nvidia_smi": smi}
        lines.append(line)
        print(json.dumps(line), flush=True)
    accurate = [ln for ln in lines if ln["f32_accurate"]]
    print(json.dumps({"f32_accurate": [ln["candidate"] for ln in accurate],
                      "fastest_f32_accurate": min(
                          accurate, key=lambda ln: ln["step_ms_median"],
                          default={}).get("candidate")}))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
