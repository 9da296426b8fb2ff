"""The paper's experiment models (§V), port of `repro.models.small`: a
4-layer MLP (MNIST) and a 6-layer CNN (CIFAR), log-softmax heads.

MNIST net: 4 fully-connected layers with ReLU.
CIFAR net: conv 3→64, 64→120, 120→200 (3×3 "SAME", each followed by ReLU
and a 2×2 max-pool), then fc → 128 with ReLU and fc → 10.

Parameters are plain dicts in the JAX layout and names:
``{"fc0": {"w": (d_in, d_out), "b": (d_out,)}, ...}``, conv weights HWIO
``{"conv0": {"w": (3, 3, c_in, c_out), "b": (c_out,)}, ...}``, so a JAX
tree crosses unchanged (`repro_torch.convert.params_from_jax`) and the
flat parameter vector has JAX's order.  ``apply`` takes either one
model's params with inputs (B, H, W, C), or K-stacked params (every leaf
with a leading K) with inputs (K, B, H, W, C): the MLP's layers then run
as batched matmuls over the K clients, the CNN's convolutions as one
grouped convolution (``groups=K``, channels-last) a layer.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _dense_init(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    scale = (2.0 / d_in) ** 0.5
    return {"w": scale * torch.randn(d_in, d_out, generator=gen,
                                     device=gen.device),
            "b": torch.zeros(d_out, device=gen.device)}


def _conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
               c_out: int) -> dict:
    scale = (2.0 / (kh * kw * c_in)) ** 0.5
    return {"w": scale * torch.randn(kh, kw, c_in, c_out, generator=gen,
                                     device=gen.device),
            "b": torch.zeros(c_out, device=gen.device)}


def _conv_relu_pool(x: torch.Tensor, p: dict) -> torch.Tensor:
    """3×3 "SAME" convolution + bias, ReLU and a 2×2/2 max-pool on
    ``x`` (B, C_in, H, W), HWIO weights.  K-stacked weights (K, 3, 3,
    C_in, C_out) take ``x`` as (B, K·C_in, H, W), client k's channels at
    [k·C_in, (k+1)·C_in), and run as one convolution with ``groups=K``;
    the output keeps that layout, (B, K·C_out, H/2, W/2).  Input and
    weights go channels-last: cuDNN runs the grouped convolution 1.5×
    faster so, at the same accuracy (`scripts/cnn_conv_candidates.py`)."""
    w, b = p["w"], p["b"]
    if w.ndim == 5:
        K, kh, kw, c_in, c_out = w.shape
        w = w.permute(0, 4, 3, 1, 2).reshape(K * c_out, c_in, kh, kw)
        b, groups = b.reshape(-1), K
    else:
        w, groups = w.permute(3, 2, 0, 1), 1
    cl = torch.channels_last
    y = F.conv2d(x.contiguous(memory_format=cl),
                 w.contiguous(memory_format=cl), b, padding=1, groups=groups)
    return F.max_pool2d(torch.relu(y), 2)


def make_mnist_mlp(input_hw=(28, 28, 1), hidden: Sequence[int] = (200, 100, 64),
                   num_classes: int = 10):
    """Returns ``(init, apply)``; ``init(generator)`` draws He-normal
    weights on the generator's device."""
    d_in = input_hw[0] * input_hw[1] * input_hw[2]
    dims = [d_in, *hidden, num_classes]
    n = len(dims) - 1

    def init(gen: torch.Generator) -> dict:
        return {f"fc{i}": _dense_init(gen, dims[i], dims[i + 1])
                for i in range(n)}

    def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
        h = x.flatten(start_dim=-3)
        for i in range(n):
            p = params[f"fc{i}"]
            h = h @ p["w"] + p["b"].unsqueeze(-2)
            if i < n - 1:
                h = torch.relu(h)
        return torch.log_softmax(h, dim=-1)

    return init, apply


def make_cifar_cnn(input_hw=(32, 32, 3), num_classes: int = 10):
    """Returns ``(init, apply)``; ``init(generator)`` draws He-normal
    weights on the generator's device.  ``apply`` permutes NHWC inputs
    and HWIO weights to torch's NCHW / OIHW inside, and flattens the last
    pool's output in NHWC order before ``fc0``, as JAX does."""
    h, w, c = input_hw
    # three 2x2 pools: spatial /8
    flat = (h // 8) * (w // 8) * 200

    def init(gen: torch.Generator) -> dict:
        return {"conv0": _conv_init(gen, 3, 3, c, 64),
                "conv1": _conv_init(gen, 3, 3, 64, 120),
                "conv2": _conv_init(gen, 3, 3, 120, 200),
                "fc0": _dense_init(gen, flat, 128),
                "fc1": _dense_init(gen, 128, num_classes)}

    def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
        stacked = x.ndim == 5
        if stacked:                     # (K, B, H, W, C) -> (B, K·C, H, W)
            K, B = x.shape[:2]
            h = x.permute(1, 0, 4, 2, 3).reshape(B, K * x.shape[4],
                                                 *x.shape[2:4])
        else:                           # (B, H, W, C) -> (B, C, H, W)
            h = x.permute(0, 3, 1, 2)
        for name in ("conv0", "conv1", "conv2"):
            h = _conv_relu_pool(h, params[name])
        if stacked:                     # NHWC flatten, client by client
            h = h.reshape(B, K, -1, *h.shape[2:]).permute(1, 0, 3, 4, 2)
        else:
            h = h.permute(0, 2, 3, 1)
        h = h.flatten(start_dim=-3)
        p0, p1 = params["fc0"], params["fc1"]
        h = torch.relu(h @ p0["w"] + p0["b"].unsqueeze(-2))
        h = h @ p1["w"] + p1["b"].unsqueeze(-2)
        return torch.log_softmax(h, dim=-1)

    return init, apply


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL on log-softmax outputs, the mean over the batch axis (the last
    axis of ``labels``): a scalar, or (K,) for stacked clients."""
    picked = torch.gather(log_probs, -1, labels.unsqueeze(-1)).squeeze(-1)
    return -torch.mean(picked, dim=-1)


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(log_probs, dim=-1) == labels)
                      .to(torch.float32), dim=-1)
