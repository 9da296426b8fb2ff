"""Synthetic stand-ins for MNIST and CIFAR (port of
`repro.data.synthetic`; the files of the real sets are not in the repo).

Images are drawn from a fixed random teacher: each of the 10 classes has a
smooth prototype image (low-res noise, bilinearly upsampled); a sample is
prototype[y] + noise.  Layout is NHWC, as in the JAX package.

* ``mnist-like``: 28×28×1, 60k train / 10k test, 10 classes.
* ``cifar-like``: 32×32×3, 50k train / 10k test, 10 classes.

Partitioners follow §V: IID = random equal split across K clients;
non-IID = sort by label, cut into 200 disjoint shards, deal
``shards_per_client`` shards to each client.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
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

    @staticmethod
    def cifar_like(num_train: int = 50000, num_test: int = 10000):
        return SyntheticImageConfig("cifar-like", 32, 32, 3, 10,
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


def deal_shards(x: torch.Tensor, y: torch.Tensor, shard_perm: torch.Tensor,
                num_clients: int, shards_per_client: int,
                num_shards: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's label-sorted sharding, given the shard permutation:
    sort by class (a stable sort), keep ``num_shards`` disjoint shards of
    ``usable // num_shards`` examples, and deal the shards
    ``shard_perm[:K·spc]`` to the clients in order, ``shards_per_client``
    each.  Returns stacked (K, spc·shard_size, ...) arrays."""
    need = num_clients * shards_per_client
    if need > num_shards:
        raise ValueError(f"need {need} shards but only {num_shards} exist")
    n = x.shape[0]
    usable = (n // num_shards) * num_shards
    order = torch.sort(y, stable=True).indices[:usable]
    shards = order.reshape(num_shards, usable // num_shards)
    chosen = shard_perm[:need].to(y.device).reshape(num_clients,
                                                    shards_per_client)
    idx = shards[chosen].reshape(num_clients, -1)
    return x[idx], y[idx]


def partition_noniid(seed: int, x: torch.Tensor, y: torch.Tensor,
                     num_clients: int, shards_per_client: int,
                     num_shards: int = 200
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-IID split (paper §V; MNIST: 4 shards a client, CIFAR: 7):
    :func:`deal_shards` with a permutation of the shards drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(x.device).manual_seed(seed)
    perm = torch.randperm(num_shards, generator=gen, device=x.device)
    return deal_shards(x, y, perm, num_clients, shards_per_client,
                       num_shards)


def label_histogram(ys: torch.Tensor, num_classes: int = 10) -> np.ndarray:
    """(K, num_classes) int64 per-client label counts — for non-IID sanity
    checks."""
    return np.stack([np.bincount(row, minlength=num_classes)
                     for row in ys.cpu().numpy()]).astype(np.int64)
