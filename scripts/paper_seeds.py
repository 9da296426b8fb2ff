#!/usr/bin/env python3
"""The port's paper rows over many seeds: the spread that
``chip_smoke.py``'s paper floors must allow for.

    PYTHONPATH=src python3 scripts/paper_seeds.py [--device cpu] \\
        [--seeds 8] [--rounds 3] [row ...]

Runs ``repro_torch.paper.common.run_setting`` at the paper's full scale
(``BenchScale.full()``, non-IID), cut to ``--rounds`` rounds, for the rows
of ``chip_smoke.py``'s paper phase (or the ones named) at seeds
S = 0 .. seeds-1 (data S, partition S+1, topology S+7, run S, as
``scripts/jax_paper_reference.py --seed S`` seeds the JAX package's
runs).  Prints one JSON line a row and seed with its per-round test
accuracy, final and mean accuracy, steady rounds/s (rounds 2..T of the
scan's execute phase) and, on the card, peak device memory; then the
card's name and power limit.  About 3 s a CIFAR row on an H100 at 3
rounds; ``--seeds 1 --rounds 70`` runs the paper's full length.
"""
import argparse
import dataclasses
import json
import subprocess

import torch

from repro_torch.obs import PhaseTimers
from repro_torch.paper.common import BenchScale, run_setting
from repro_torch.paper.table1_accuracy import ROWS as TABLE1
from repro_torch.utils.device import resolve_device

# label: (dataset, strategy, clusters, µ_p) — Table I's CIFAR column and
# MNIST CWFL-4, as chip_smoke.PAPER_RUNS
ROWS = {f"{ds}/{label}": (ds, strategy, C, mu)
        for ds in ("cifar", "mnist") for label, strategy, C, mu in TABLE1
        if (label == "CWFL-4") == (ds == "mnist")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("rows", nargs="*")
    args = ap.parse_args()
    device = resolve_device(args.device)
    scale = dataclasses.replace(BenchScale.full(), rounds=args.rounds)
    for label in args.rows or list(ROWS):
        ds, strategy, C, mu = ROWS[label]
        for seed in range(args.seeds):
            timers = PhaseTimers()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            h = run_setting(ds, False, strategy, scale, num_clusters=C,
                            mu_prox=mu, seed=seed, device=device,
                            timers=timers)
            line = {"row": label, "seed": seed, "rounds": scale.rounds,
                    "test_acc": h["test_acc"], "final_acc": h["final_acc"],
                    "avg_acc": float(h["avg_acc"]),
                    "train_loss": h["train_loss"],
                    # rounds 2..T over the scan's execute phase
                    "steady_rounds_per_s": (scale.rounds - 1)
                    / timers.seconds["execute"],
                    "device": str(device)}
            if device.type == "cuda":
                line["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                    device)
            print(json.dumps(line), flush=True)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
