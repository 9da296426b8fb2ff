"""The paper's two models (§V), plain, over N stacked clients at once.

Parameters are dicts ``{layer: {"w", "b"}}`` whose leaves carry a leading
client axis N; inputs are (N, batch, H, W, C).  The MLP is a chain of
batched matmuls with ReLU; the CNN runs each 3×3 "SAME" convolution of
the N clients as one grouped convolution in NCHW (``groups=N``), ReLU
and a 2×2 max-pool, then flattens in NHWC order before the dense head.
Both end in a log-softmax; the loss is the mean NLL over the batch.

``rnd`` is applied to the operands of every matmul and convolution: the
identity for the reference proper, `tf32` for the lower-precision
control.  TF32 keeps 10 mantissa bits of an f32 operand.  The TF32 flag
alone moved the CNN's numbers no more than a change of summation order
does (its grouped convolutions read as f32 on the H100), so the control
rounds the forward operands itself, and the flag takes the matmuls'
backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32, 10 mantissa bits, to nearest even;
    infinities and NaNs kept.  The gradient passes through unchanged."""
    with torch.no_grad():
        i = x.detach().contiguous().view(torch.int32)
        r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
        step = torch.where(torch.isfinite(x), r - x, 0.0)
    return x + step


def mlp_apply(params: dict, x: torch.Tensor, rnd=identity) -> torch.Tensor:
    h = x.flatten(start_dim=2)
    names = sorted(params, key=lambda n: int(n[2:]))
    for i, name in enumerate(names):
        h = torch.baddbmm(params[name]["b"].unsqueeze(1), rnd(h),
                          rnd(params[name]["w"]))
        if i < len(names) - 1:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=-1)


def cnn_apply(params: dict, x: torch.Tensor, rnd=identity) -> torch.Tensor:
    N, B, H, W, C = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(B, N * C, H, W)
    for name in ("conv0", "conv1", "conv2"):
        w, b = params[name]["w"], params[name]["b"]
        c_in, c_out = w.shape[3], w.shape[4]
        w = w.permute(0, 4, 3, 1, 2).reshape(N * c_out, c_in, 3, 3)
        h = F.conv2d(rnd(h), rnd(w), b.reshape(-1), padding=1, groups=N)
        h = F.max_pool2d(torch.relu(h), 2)
    c = params["conv2"]["w"].shape[4]
    h = h.reshape(B, N, c, *h.shape[2:]).permute(1, 0, 3, 4, 2)
    h = h.reshape(N, B, -1)
    h = torch.relu(torch.baddbmm(params["fc0"]["b"].unsqueeze(1), rnd(h),
                                 rnd(params["fc0"]["w"])))
    h = torch.baddbmm(params["fc1"]["b"].unsqueeze(1), rnd(h),
                      rnd(params["fc1"]["w"]))
    return torch.log_softmax(h, dim=-1)


APPLY = {"mlp": mlp_apply, "cnn": cnn_apply}


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N,) mean NLL over each client's batch."""
    return -torch.gather(log_probs, -1, labels.unsqueeze(-1)).squeeze(-1
                                                                      ).mean(-1)
