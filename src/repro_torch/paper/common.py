"""The paper's experiment grid, scaled (twin of the JAX package's
``benchmarks/common.py``).

``BenchScale()`` runs a reduced-but-faithful version of §V: fewer clients,
samples and rounds, same protocol, same relative claims.
``BenchScale.full()`` restores the paper's sizes (K=50/27, 60k/50k
samples, 70 rounds).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core import TopologyConfig, make_topology
from repro_torch.data import (SyntheticImageConfig, make_synthetic_images,
                              partition_iid, partition_noniid)
from repro_torch.models import make_cifar_cnn, make_mnist_mlp, nll_loss
from repro_torch.training import FLConfig, run_federated
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class BenchScale:
    mnist_clients: int = 20
    cifar_clients: int = 9
    mnist_train: int = 6000
    cifar_train: int = 1350
    test: int = 1200
    rounds: int = 22
    eval_samples: int = 1024
    mnist_shards_per_client: int = 4
    cifar_shards_per_client: int = 7

    @staticmethod
    def full() -> "BenchScale":
        return BenchScale(mnist_clients=50, cifar_clients=27,
                          mnist_train=60000, cifar_train=50000, test=10000,
                          rounds=70, eval_samples=4096)


def make_dataset(name: str, scale: BenchScale, seed: int, device=None
                 ) -> dict:
    """The synthetic set of ``name`` (``"mnist"`` or ``"cifar"``) at
    ``scale``, drawn from ``seed`` on ``device``, with the paper's model,
    client count, shards a client and batch size for it."""
    if name == "mnist":
        cfg = SyntheticImageConfig.mnist_like(scale.mnist_train, scale.test)
        K = scale.mnist_clients
        spc = scale.mnist_shards_per_client
        init, apply = make_mnist_mlp()
        batch = 64
    else:
        cfg = SyntheticImageConfig.cifar_like(scale.cifar_train, scale.test)
        K = scale.cifar_clients
        spc = scale.cifar_shards_per_client
        init, apply = make_cifar_cnn()
        batch = 32
    (xtr, ytr), (xte, yte) = make_synthetic_images(seed, cfg, device=device)
    return dict(x=xtr, y=ytr, x_test=xte, y_test=yte, K=K,
                shards_per_client=spc, init=init, apply=apply, batch=batch)


def make_setting(name: str, iid: bool, strategy: str, scale: BenchScale,
                 *, num_clusters: int = 3, mu_prox: float = 0.0,
                 seed: int = 0, snr_db: float = 40.0, device=None):
    """One Fig. 2 curve's inputs on ``device`` (``None`` = the GPU): data
    from ``seed``, topology from ``seed + 7``, partition from ``seed + 1``,
    as the JAX package seeds its keys.  Returns ``((init, apply, loss,
    topology, xs, ys, x_test, y_test), cfg)``, the arguments of
    `repro_torch.sim.run_rounds` and its `FLConfig`."""
    device = resolve_device(device)
    data = make_dataset(name, scale, seed, device=device)
    K = data["K"]
    topo = make_topology(seed + 7,
                         TopologyConfig(num_clients=K,
                                        num_hotspots=max(num_clusters, 3)),
                         device=device)
    if iid:
        xs, ys = partition_iid(seed + 1, data["x"], data["y"], K)
    else:
        # paper: 200 shards; scaled runs reduce shard count proportionally
        num_shards = max(K * data["shards_per_client"], 40)
        xs, ys = partition_noniid(seed + 1, data["x"], data["y"], K,
                                  data["shards_per_client"],
                                  num_shards=num_shards)
    apply = data["apply"]

    def loss(p, x, y):
        return nll_loss(apply(p, x), y)

    cfg = FLConfig(strategy=strategy, rounds=scale.rounds,
                   batch_size=data["batch"], num_clusters=num_clusters,
                   snr_db=snr_db, mu_prox=mu_prox,
                   eval_samples=scale.eval_samples, seed=seed)
    return ((data["init"], apply, loss, topo, xs, ys, data["x_test"],
             data["y_test"]), cfg)


def run_setting(name: str, iid: bool, strategy: str, scale: BenchScale, *,
                num_clusters: int = 3, mu_prox: float = 0.0,
                seed: int = 0, snr_db: float = 40.0, device=None,
                progress=None, mode=None, timers=None) -> dict:
    """One Fig. 2 curve on ``device`` (``None`` = the GPU), its inputs
    :func:`make_setting`'s.  ``progress(r, loss, acc)``: as
    `run_federated`'s, as are ``mode`` and ``timers``.  Returns
    `run_federated`'s history with ``seconds_per_round`` (wall, over the
    whole run)."""
    device = resolve_device(device)
    workload, cfg = make_setting(name, iid, strategy, scale,
                                 num_clusters=num_clusters, mu_prox=mu_prox,
                                 seed=seed, snr_db=snr_db, device=device)
    t0 = time.perf_counter()
    h = run_federated(*workload, cfg, progress=progress, device=device,
                      mode=mode, timers=timers)
    h["seconds_per_round"] = (time.perf_counter() - t0) / scale.rounds
    return h
