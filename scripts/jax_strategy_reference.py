#!/usr/bin/env python3
"""The JAX package's reference for ``chip_smoke.py``'s strategies and
quickstart phases.

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python scripts/jax_strategy_reference.py [--seed S] [--quickstart] \\
        [strategy ...]

Runs `repro.training.run_federated` (the JAX package, the port's
reference) on the static scenario at the configuration ``chip_smoke.py``
drives the port at, one JSON line per strategy with its per-round train
loss and test accuracy:

* by default, the strategies phase: the paper's MNIST MLP
  (784-200-100-64-10), K=50 clients, C=3 clusters, 40 dB, the
  60,000/10,000 mnist-like set split IID, 5 rounds, for ``fedavg``,
  ``cotaf``, ``decentralized``, ``cwfl_prox`` and ``cotaf_prox`` (or the
  strategies named);
* with ``--quickstart``, ``examples/quickstart.py``'s setup: K=16 around 3
  hotspots, the 6,000/1,500 set, 12 rounds, ``eval_samples`` 1,024, for
  ``cwfl`` and ``fedavg``.

Topology key S, data key S+1, partition key S+2, run seed S (S = 0 by
default, the JAX quickstart's and ``chip_smoke.py``'s seeding).  The
phases' accuracy floors are derived from its runs at S = 0, 3, 6 and 9.
About 20 s and 2 GB of host memory a strategy at K=50 on the CPU.
"""
import argparse
import json
import time

import jax

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.training import FLConfig, run_federated

STRATEGIES = ("fedavg", "cotaf", "decentralized", "cwfl_prox", "cotaf_prox")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quickstart", action="store_true")
    ap.add_argument("strategies", nargs="*")
    args = ap.parse_args()
    s = args.seed
    if args.quickstart:
        K, rounds, eval_samples = 16, 12, 1024
        tcfg = jtopo.TopologyConfig(num_clients=K, num_hotspots=3)
        dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=6000,
                                                     num_test=1500)
        strategies = args.strategies or ["cwfl", "fedavg"]
    else:
        K, rounds, eval_samples = 50, 5, 2048
        tcfg = jtopo.TopologyConfig(num_clients=K)
        dcfg = jdata.SyntheticImageConfig.mnist_like()
        strategies = args.strategies or list(STRATEGIES)
    topo = jtopo.make_topology(jax.random.PRNGKey(s), tcfg)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(s + 1), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(s + 2), xtr, ytr, K)
    init, apply = jsmall.make_mnist_mlp(hidden=(200, 100, 64))

    def loss(p, x, y):
        return jsmall.nll_loss(apply(p, x), y)

    for name in strategies:
        cfg = FLConfig(strategy=name, rounds=rounds, num_clusters=3,
                       snr_db=40.0, eval_samples=eval_samples, seed=s)
        t0 = time.perf_counter()
        h = run_federated(init, apply, loss, topo, xs, ys, xte, yte, cfg)
        print(json.dumps({"strategy": name, "seed": s, "K": K,
                          "rounds": rounds, "train_loss": h["train_loss"],
                          "test_acc": h["test_acc"],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
