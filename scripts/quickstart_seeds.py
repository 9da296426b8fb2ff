#!/usr/bin/env python3
"""The port's quickstart over many seeds: the spread that
``chip_smoke.py``'s quickstart floors must allow for.

    PYTHONPATH=src python scripts/quickstart_seeds.py [--device cpu] \\
        [--seeds 16]

Runs ``examples/quickstart_torch.run`` (12 rounds of ``cwfl`` and of
``fedavg``, K=16 around 3 hotspots, the 6,000/1,500 mnist-like set split
IID) for S = 0 .. seeds-1: topology seed S, data seed S+1, partition seed
S+2 and the runs' draws from seed S, all drawn on the CPU and then moved
to ``--device`` (the GPU by default), as
``scripts/jax_strategy_reference.py --quickstart --seed S`` seeds the JAX
package's runs.  Prints one JSON line a seed with both runs' per-round
test accuracy.  About 5 s a seed on the CPU.
"""
import argparse
import contextlib
import importlib.util
import io
import json
from pathlib import Path

from repro_torch.core import TopologyConfig, make_topology
from repro_torch.data import (SyntheticImageConfig, make_synthetic_images,
                              partition_iid)
from repro_torch.sim import TorchDraws
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    device = resolve_device(args.device)
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    K = quickstart.K
    for s in range(args.seeds):
        topo = make_topology(s, TopologyConfig(num_clients=K, num_hotspots=3),
                             device="cpu")
        (xtr, ytr), (xte, yte) = make_synthetic_images(
            s + 1, SyntheticImageConfig.mnist_like(6000, 1500), device="cpu")
        xs, ys = partition_iid(s + 2, xtr, ytr, K)
        with contextlib.redirect_stdout(io.StringIO()):
            out = quickstart.run(topo, (xs, ys, xte, yte), first=0,
                                 device=device,
                                 draws=lambda: TorchDraws(s, "cpu"))
        print(json.dumps({"seed": s, "device": str(device), **{
            name: h["test_acc"] for name, h in out["histories"].items()}}),
            flush=True)


if __name__ == "__main__":
    main()
