#!/usr/bin/env python3
"""The JAX package's reference for ``chip_smoke.py``'s paper phase.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu \\
        python scripts/jax_paper_reference.py [--seed S] [--rounds R] \\
        [--check] [row ...]

Runs the JAX package's Table I setting (``benchmarks/common.run_setting``'s
data, split, topology and config) at the paper's full scale
(``BenchScale.full()``: CIFAR K=27, the 50,000/10,000 cifar-like set, 7 of
189 label-sorted shards a client, batch 32; MNIST K=50, 60,000/10,000, 4 of
200 shards a client, batch 64; eval on 4,096 samples; 40 dB), non-IID, cut to
``--rounds`` rounds (3 by default), one JSON line per row with its
per-round train loss and test accuracy.  The rows are the paper phase's:
the CIFAR column of Table I (COTAF, COTAF-Prox, CWFL-3, CWFL-3-Prox) and
MNIST CWFL-4, or the ones named.  Seeds as ``run_setting``'s: data key S,
partition key S+1, topology key S+7, run seed S.  The phase's accuracy
floors are derived from its runs at several seeds.

XLA's CPU backend runs the CNN about 20 times slower inside a while loop
than outside one (64 s against 3.4 s a step of 27 clients × 32 images), and
unrolling the local runner's 54-step ``lax.scan`` makes XLA plan 131 GB of
buffers.  So the static round of `repro.sim.engine` is driven here from
Python, with the engine's own pieces: its ``prepare`` (offline state,
initial params, optimizer state and round keys), the runner's step (the
minibatch draw, ``value_and_grad`` of the loss or of `fedprox_wrap`'s
objective anchored at the round's start, the optimizer's update), one
jitted call a step over the K clients with the keys the runner would
split, then the strategy's ``aggregate`` and the accuracy on the eval
set.  ``--check`` holds this driver against `run_federated` at a small
CNN shape first.  A CIFAR row takes about 10 minutes on 8 cores and 7 GB
of host memory.
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.common import BenchScale, make_dataset
from benchmarks.table1_accuracy import ROWS as TABLE1
from repro.core import TopologyConfig, make_topology
from repro.data import partition_noniid
from repro.models import nll_loss
from repro.sim import engine
from repro.sim.scenarios import Scenario
from repro.strategies import get_strategy
from repro.training import FLConfig, run_federated
from repro.training.local import fedprox_wrap

# label: (dataset, strategy, clusters, µ_p) — Table I's CIFAR column and
# MNIST CWFL-4
ROWS = {f"{ds}/{label}": (ds, strategy, C, mu)
        for ds in ("cifar", "mnist") for label, strategy, C, mu in TABLE1
        if (label == "CWFL-4") == (ds == "mnist")}


def run_static(init_fn, apply_fn, loss_fn, topology, xs, ys, x_test, y_test,
               cfg):
    """`run_federated`'s static trajectory, its local steps one jitted call
    each; returns ``(train_loss, test_acc)`` lists."""
    K, n_k = xs.shape[0], xs.shape[1]
    strategy = get_strategy(cfg.strategy)
    optimizer, _ = engine.make_round_local_runner(loss_fn, cfg, n_k)
    steps = max(cfg.local_epochs * (n_k // cfg.batch_size), 1)
    mu = strategy.effective_mu_prox(cfg.mu_prox)
    grad_fn = jax.value_and_grad(fedprox_wrap(loss_fn, mu) if mu > 0.0
                                 else loss_fn)
    prepare, _ = engine._build(init_fn, apply_fn, loss_fn, topology, xs, ys,
                               x_test, y_test, cfg, Scenario(), None)
    state0, carry, scan_xs = prepare(cfg.seed, cfg.snr_db)

    def client_step(p, s, x, y, k, anchor):
        idx = jax.random.randint(k, (cfg.batch_size,), 0, x.shape[0])
        extra = (anchor,) if mu > 0.0 else ()
        loss, grads = grad_fn(p, x[idx], y[idx], *extra)
        updates, s = optimizer.update(grads, s, p)
        return jax.tree.map(jnp.add, p, updates), s, loss

    step = jax.jit(jax.vmap(client_step))
    sync = jax.jit(lambda trained, k: strategy.aggregate(trained, state0, k))
    x_ev, y_ev = x_test[: cfg.eval_samples], y_test[: cfg.eval_samples]
    evaluate = jax.jit(lambda p: jnp.mean(
        jnp.argmax(apply_fn(p, x_ev), -1) == y_ev))
    stacked, opt = carry["stacked"], carry["opt"]
    losses, accs = [], []
    for t in range(cfg.rounds):
        k_local, k_agg = jax.random.split(scan_xs["rkey"][t])
        keys = jax.vmap(lambda k: jax.random.split(k, steps))(
            jax.random.split(k_local, K))
        anchor, per_step = stacked, []
        for i in range(steps):
            stacked, opt, loss = step(stacked, opt, xs, ys, keys[:, i],
                                      anchor)
            per_step.append(loss)
        stacked, consensus = sync(stacked, k_agg)
        losses.append(float(jnp.mean(jnp.mean(jnp.stack(per_step), 0))))
        accs.append(float(evaluate(consensus)))
    return losses, accs


def setting(name, strategy, C, mu, scale, seed):
    """``run_setting``'s non-IID inputs: the model, data, split, topology
    and config."""
    key = jax.random.PRNGKey(seed)
    data = make_dataset(name, scale, key)
    K = data["K"]
    topo = make_topology(jax.random.PRNGKey(seed + 7),
                         TopologyConfig(num_clients=K,
                                        num_hotspots=max(C, 3)))
    xs, ys = partition_noniid(jax.random.PRNGKey(seed + 1), data["x"],
                              data["y"], K, data["shards_per_client"],
                              num_shards=max(K * data["shards_per_client"],
                                             40))
    apply = data["apply"]
    cfg = FLConfig(strategy=strategy, rounds=scale.rounds,
                   batch_size=data["batch"], num_clusters=C, snr_db=40.0,
                   mu_prox=mu, eval_samples=scale.eval_samples, seed=seed)
    return (data["init"], apply, lambda p, x, y: nll_loss(apply(p, x), y),
            topo, xs, ys, data["x_test"], data["y_test"], cfg)


def check() -> None:
    """The driver against `run_federated` on a small CIFAR setting."""
    scale = BenchScale(cifar_clients=4, cifar_train=960, test=256, rounds=2,
                       eval_samples=256)
    for strategy, mu in (("cwfl", 0.0), ("cotaf", 0.1)):
        args = setting("cifar", strategy, 3, mu, scale, 0)
        ref = run_federated(*args)
        loss, acc = run_static(*args)
        np.testing.assert_allclose(loss, ref["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(acc, ref["test_acc"], atol=2 / 256)
        print(json.dumps({"check": strategy, "mu_prox": mu,
                          "train_loss": loss,
                          "engine_train_loss": ref["train_loss"],
                          "test_acc": acc, "engine_test_acc":
                          ref["test_acc"]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("rows", nargs="*")
    args = ap.parse_args()
    if args.check:
        check()
    scale = dataclasses.replace(BenchScale.full(), rounds=args.rounds)
    for label in args.rows or list(ROWS):
        ds, strategy, C, mu = ROWS[label]
        t0 = time.perf_counter()
        loss, acc = run_static(*setting(ds, strategy, C, mu, scale,
                                        args.seed))
        print(json.dumps({"row": label, "seed": args.seed,
                          "rounds": args.rounds, "train_loss": loss,
                          "test_acc": acc,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
