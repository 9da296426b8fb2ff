"""The paper's MNIST model (§V): a 4-layer MLP with ReLU and a log-softmax
head (port of `repro.models.small`).

Parameters are a plain dict in the JAX layout and names:
``{"fc0": {"w": (d_in, d_out), "b": (d_out,)}, ...}``.  ``apply`` takes
either one model's params with inputs (B, H, W, C), or K-stacked params
(every leaf with a leading K) with inputs (K, B, H, W, C), in which case
the layers run as batched matmuls over the K clients.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _dense_init(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    scale = (2.0 / d_in) ** 0.5
    return {"w": scale * torch.randn(d_in, d_out, generator=gen,
                                     device=gen.device),
            "b": torch.zeros(d_out, device=gen.device)}


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


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL on log-softmax outputs, the mean over the batch axis (the last
    axis of ``labels``): a scalar, or (K,) for stacked clients."""
    picked = torch.gather(log_probs, -1, labels.unsqueeze(-1)).squeeze(-1)
    return -torch.mean(picked, dim=-1)


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(log_probs, dim=-1) == labels)
                      .to(torch.float32), dim=-1)
