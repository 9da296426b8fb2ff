#!/usr/bin/env python3
"""The JAX package's reference for ``chip_smoke.py``'s full-width runs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/jax_scenario_reference.py \\
        [--seed S] paper-static head-failure flaky-clients mobile-fading \\
        cluster-churn

Runs `repro.training.run_federated` (the JAX package, the port's
reference) at the configuration ``chip_smoke.py`` drives the port at: the
paper's MNIST MLP (784-200-100-64-10), K=50 clients, C=3 clusters, 40 dB,
the 60,000/10,000 mnist-like set split IID, 5 rounds; topology key S,
data key S+1, partition key S+2, run seed S (S = 0 by default, the seeding
``chip_smoke.py`` uses).  Prints one JSON line per scenario with its
per-round train loss and test accuracy.  ``chip_smoke.py``'s scenario
floors (``SCENARIO_FLOOR``, ``STATIC_GAP``) are derived from its runs at
S = 0, 3, 6 and 9.  About 20 s and 2 GB of host memory per scenario on the
CPU.
"""
import argparse
import json
import time

import jax

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.sim.scenarios import get_scenario
from repro.training import FLConfig, run_federated

K = 50


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("scenarios", nargs="*", default=["paper-static"])
    args = ap.parse_args()
    s = args.seed
    tcfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.make_topology(jax.random.PRNGKey(s), tcfg)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(s + 1), jdata.SyntheticImageConfig.mnist_like())
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(s + 2), xtr, ytr, K)
    init, apply = jsmall.make_mnist_mlp(hidden=(200, 100, 64))

    def loss(p, x, y):
        return jsmall.nll_loss(apply(p, x), y)

    cfg = FLConfig(rounds=5, num_clusters=3, snr_db=40.0, seed=s)
    for name in args.scenarios:
        t0 = time.perf_counter()
        h = run_federated(init, apply, loss, topo, xs, ys, xte, yte, cfg,
                          scenario=get_scenario(name), topo_cfg=tcfg)
        print(json.dumps({"scenario": name, "seed": s,
                          "train_loss": h["train_loss"],
                          "test_acc": h["test_acc"],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
