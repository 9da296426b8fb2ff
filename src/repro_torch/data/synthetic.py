"""Synthetic stand-in for MNIST (port of `repro.data.synthetic`).

Images are drawn from a fixed random teacher: each of the 10 classes has a
smooth prototype image (low-res noise, bilinearly upsampled); a sample is
prototype[y] + noise.  Layout is NHWC, as in the JAX package.  The IID
partitioner is a random equal split across K clients (paper §V).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticImageConfig:
    name: str = "mnist-like"
    height: int = 28
    width: int = 28
    channels: int = 1
    num_classes: int = 10
    num_train: int = 60000
    num_test: int = 10000
    noise_std: float = 0.35      # intra-class variability
    smoothness: int = 4          # prototype low-res grid (upsampled -> smooth)

    @staticmethod
    def mnist_like(num_train: int = 60000, num_test: int = 10000):
        return SyntheticImageConfig("mnist-like", 28, 28, 1, 10,
                                    num_train, num_test)


def _prototypes(low: torch.Tensor, cfg: SyntheticImageConfig
                ) -> torch.Tensor:
    """Smooth class prototypes from (N, s, s, C) low-res noise: bilinear
    upsampling (half-pixel centres, as ``jax.image.resize``), scaled to
    unit population std."""
    protos = F.interpolate(low.permute(0, 3, 1, 2),
                           size=(cfg.height, cfg.width), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    return protos / torch.clamp(protos.std(correction=0), min=1e-6)


def make_synthetic_images(seed: int, cfg: SyntheticImageConfig,
                          device=None
                          ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``((x_train, y_train), (x_test, y_test))``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` =
    the GPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    low = torch.randn(cfg.num_classes, cfg.smoothness, cfg.smoothness,
                      cfg.channels, generator=gen, device=device)
    protos = _prototypes(low, cfg)

    def sample(n):
        y = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                          device=device)
        noise = cfg.noise_std * torch.randn(
            n, cfg.height, cfg.width, cfg.channels, generator=gen,
            device=device)
        return protos[y] + noise, y

    return sample(cfg.num_train), sample(cfg.num_test)


def partition_iid(seed: int, x: torch.Tensor, y: torch.Tensor,
                  num_clients: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random equal split. Returns stacked (K, N_k, ...) arrays."""
    gen = torch.Generator(x.device).manual_seed(seed)
    n = x.shape[0]
    per = n // num_clients
    perm = torch.randperm(n, generator=gen, device=x.device)[
        : per * num_clients]
    xs = x[perm].reshape((num_clients, per) + tuple(x.shape[1:]))
    ys = y[perm].reshape(num_clients, per)
    return xs, ys
