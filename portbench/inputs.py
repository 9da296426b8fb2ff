"""The benchmark's inputs, made from ``--seed`` on the device.

Everything random that a run hands the program, and that the plain
reference reads back, comes from here: the synthetic image sets, the
non-IID partition, the client geometry and small-scale fading, the
initial parameters and every draw of every round.  Nothing here imports
the program, so the reference and the program are given the same
numbers by the same code.

The seeding follows the paper's experiment settings (data from ``seed``,
topology from ``seed + 7``, partition from ``seed + 1``).  Each stream is
a ``torch.Generator`` on the device, seeded from a hash of its name, so a
draw is a function of (seed, trajectory, round, kind) alone: the
reference regenerates any round's draws without replaying the others.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

_HALF_SQRT = 0.5 ** 0.5


def stream_seed(*parts) -> int:
    """A 63-bit generator seed from any tuple of ints and strings."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device).manual_seed(stream_seed(*parts))


# ---------------------------------------------------------------------------
# Data: the synthetic stand-ins of MNIST and CIFAR-10 (a smooth prototype a
# class, bilinearly upsampled from low-res noise, plus pixel noise), NHWC.
# ---------------------------------------------------------------------------

def make_images(cfg: dict, seed: int, device):
    """``(x_train, y_train, x_test, y_test)`` of the configuration's
    synthetic set, drawn on ``device`` in a few large calls."""
    h, w, c = cfg["input_hw"]
    n_cls = cfg["num_classes"]
    gen = generator(device, "data", seed)
    s = cfg["smoothness"]
    low = torch.randn(n_cls, s, s, c, generator=gen, device=device)
    protos = F.interpolate(low.permute(0, 3, 1, 2), size=(h, w),
                           mode="bilinear", align_corners=False
                           ).permute(0, 2, 3, 1)
    protos = protos / torch.clamp(protos.std(correction=0), min=1e-6)

    def sample(n):
        y = torch.randint(0, n_cls, (n,), generator=gen, device=device)
        x = torch.randn(n, h, w, c, generator=gen, device=device)
        return x.mul_(cfg["noise_std"]).add_(protos[y]), y

    x_train, y_train = sample(cfg["num_train"])
    x_test, y_test = sample(cfg["num_test"])
    return x_train, y_train, x_test, y_test


def partition_noniid(cfg: dict, seed: int, x: torch.Tensor, y: torch.Tensor):
    """The paper's label-sorted split: sort by class (stable), cut
    ``num_shards`` shards, deal ``shards_per_client`` to each client from a
    permutation drawn from ``seed + 1``.  Returns (K, N_k, ...) stacks."""
    K, spc, n_sh = cfg["clients"], cfg["shards_per_client"], cfg["num_shards"]
    usable = (x.shape[0] // n_sh) * n_sh
    order = torch.sort(y, stable=True).indices[:usable]
    shards = order.reshape(n_sh, usable // n_sh)
    perm = torch.randperm(n_sh, generator=generator(x.device, "part",
                                                    seed + 1),
                          device=x.device)
    idx = shards[perm[:K * spc].reshape(K, spc)].reshape(K, -1)
    return x[idx], y[idx]


# ---------------------------------------------------------------------------
# Geometry: clients around hotspots, Rayleigh fading, reciprocal links.
# ---------------------------------------------------------------------------

class Geometry(NamedTuple):
    positions: torch.Tensor   # (K, 2) f32 metres
    h_re: torch.Tensor        # (K, K) f32 small-scale fading, real part
    h_im: torch.Tensor        # (K, K) f32 imaginary part (conjugate mirror)


def make_geometry(cfg: dict, seed: int, device) -> Geometry:
    """Client positions (hotspots uniform in the area, clients Gaussian
    around a hotspot each) and CN(0, 1) fading, the upper triangle drawn
    and its conjugate mirrored below, from ``seed + 7``."""
    tc = cfg["topology"]
    K = cfg["clients"]
    gen = generator(device, "topology", seed + 7)
    hot = torch.rand(tc["num_hotspots"], 2, generator=gen,
                     device=device) * tc["area_size"]
    assign = torch.randint(0, tc["num_hotspots"], (K,), generator=gen,
                           device=device)
    jitter = torch.randn(K, 2, generator=gen, device=device)
    positions = hot[assign] + jitter * tc["hotspot_std"]
    re = torch.randn(K, K, generator=gen, device=device) / math.sqrt(2.0)
    im = torch.randn(K, K, generator=gen, device=device) / math.sqrt(2.0)
    iu = torch.triu(torch.ones(K, K, dtype=torch.bool, device=device), 1)
    return Geometry(positions, torch.where(iu, re, re.T),
                    torch.where(iu, im, -im.T))


# ---------------------------------------------------------------------------
# Parameters and the per-round draws.
# ---------------------------------------------------------------------------

def init_params(cfg: dict, device, *key) -> dict:
    """He-normal weights and zero biases in the layout the configuration's
    ``layers`` give (JAX's names: dense ``w`` (in, out), conv ``w`` HWIO),
    drawn in one call on ``device``."""
    shapes = {name: tuple(layer["w"]) for name, layer in cfg["layers"].items()}
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, "init", *key),
                       device=device)
    params, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        fan_in = math.prod(shape[:-1])
        params[name] = {"w": flat[off:off + n].reshape(shape)
                        * (2.0 / fan_in) ** 0.5,
                        "b": torch.zeros(shape[-1], device=device)}
        off += n
    return params


class ChannelDraws(NamedTuple):
    """One round's channel-process draws (the program's ``ChannelDraws``
    field order): normals of variance ½ and waypoint uniforms."""

    fade_re: torch.Tensor
    fade_im: torch.Tensor
    shadow: torch.Tensor
    waypoints: torch.Tensor


class Draws:
    """Every draw of one trajectory's seed, keyed by ``(key, round, kind)``:
    the program's draws seam (``draws=`` of ``run_federated`` and
    ``run_monte_carlo``) and the reference's source alike.  ``cfg`` is the
    configuration, for the initial parameters' layout.  It draws the kinds
    the cells' CWFL traffic consumes (the K-means centres, the weights,
    the minibatches, the two phases' noise, the channel process); a mix
    whose scenario or strategy draws more adds them here."""

    def __init__(self, cfg: dict, key: tuple, device):
        self.cfg, self.key, self.device = cfg, tuple(key), torch.device(device)

    def _gen(self, *parts) -> torch.Generator:
        return generator(self.device, *self.key, *parts)

    def kmeans_first(self, num_clients: int) -> torch.Tensor:
        return torch.randint(num_clients, (), generator=self._gen("kmeans"),
                             device=self.device)

    def init_params(self, init_fn: Optional[Callable] = None) -> dict:
        del init_fn   # the benchmark makes the weights itself
        return init_params(self.cfg, self.device, *self.key)

    def batch_indices(self, round_: int, num_clients: int, steps: int,
                      batch: int, n_k: int) -> torch.Tensor:
        return torch.randint(n_k, (num_clients, steps, batch),
                             generator=self._gen("idx", round_),
                             device=self.device)

    def phase_noise(self, round_: int, num_clusters: int, d: int):
        gen = self._gen("noise", round_)
        return tuple(torch.randn(num_clusters, d, generator=gen,
                                 device=self.device) for _ in range(2))

    def channel_init(self, num_clients: int) -> torch.Tensor:
        return torch.rand(num_clients, 2, generator=self._gen("chan0"),
                          device=self.device)

    def channel_step(self, round_: int, num_clients: int) -> ChannelDraws:
        K, gen = num_clients, self._gen("chan", round_)
        normals = torch.randn(3, K, K, generator=gen, device=self.device)
        normals.mul_(_HALF_SQRT)
        way = torch.rand(K, 2, generator=gen, device=self.device)
        return ChannelDraws(normals[0], normals[1], normals[2], way)

    def recluster_first(self, round_: int, num_clients: int) -> torch.Tensor:
        return torch.randint(num_clients, (),
                             generator=self._gen("recluster", round_),
                             device=self.device)
