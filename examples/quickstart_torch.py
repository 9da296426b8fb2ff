"""Quickstart of the PyTorch port: CWFL end to end on a synthetic
MNIST-like task — the twin of ``examples/quickstart.py``.

Builds a 16-client wireless topology, clusters it by link SNR (paper
§IV), runs 12 federated rounds of CWFL and of the ideal FedAvg server,
and prints the accuracy trajectory and the channel-use saving against
decentralized FL.  CWFL's syncs run through the ``cwfl_round`` kernel,
FedAvg's through ``ota_aggregate``; on the CPU both run their plain
versions.

    PYTHONPATH=src python examples/quickstart_torch.py               # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port draws from its own random streams (torch's, not JAX's), so its
numbers are the JAX script's in distribution, not digit for digit.
"""
import argparse
from typing import Callable, Optional

import torch

from repro_torch.core import TopologyConfig, clustering, make_topology
from repro_torch.core.cwfl import channel_uses_per_round
from repro_torch.data import (SyntheticImageConfig, make_synthetic_images,
                              partition_iid)
from repro_torch.models import make_mnist_mlp, nll_loss
from repro_torch.training import FLConfig, run_federated
from repro_torch.utils.device import resolve_device

K, CLUSTERS = 16, 3
STRATEGIES = ("cwfl", "fedavg")


def run(topology, data, *, first: int, rounds: int = 12,
        clusters: int = CLUSTERS, eval_samples: int = 1024, device=None,
        draws: Optional[Callable] = None) -> dict:
    """Cluster ``topology`` and train on ``data`` — ``(xs, ys, x_test,
    y_test)``, the clients' stacked shards and the test set — for
    ``rounds`` rounds of each of ``STRATEGIES``, printing as the JAX
    quickstart prints.

    ``first``: K-means' first centre for the printed offline plan.
    ``device``: where the runs happen (``None`` = the GPU).  ``draws``:
    ``None`` (each run draws from ``FLConfig.seed``), or a function
    returning a run's draws (`repro_torch.sim.draws.Draws`), called once
    a run.  Returns ``{"plan", "channel_uses", "histories"}``, the
    histories of `run_federated` by strategy."""
    num_clients = topology.num_clients
    print("== topology & SNR clustering (offline phase) ==")
    plan = clustering.make_cluster_plan(topology.link_snr,
                                        topology.adjacency, clusters, first)
    print(f"clients: {num_clients}, clusters: {plan.assignment.tolist()}")
    print(f"cluster heads: {plan.heads.tolist()}")
    snr_db = [round(float(10 * torch.log10(x)), 1) for x in plan.cluster_snr]
    print(f"cluster SNRs (dB): {snr_db}")
    uses = channel_uses_per_round(num_clients, clusters)
    print(f"channel uses/round: CWFL={uses['cwfl']} vs "
          f"decentralized={uses['decentralized']} "
          f"({uses['decentralized'] / uses['cwfl']:.0f}x saving)\n")

    print("== data (synthetic MNIST-like, IID split) ==")
    xs, ys, x_test, y_test = data
    init, apply = make_mnist_mlp()

    def loss(p, x, y):
        return nll_loss(apply(p, x), y)

    histories = {}
    for strategy in STRATEGIES:
        print(f"== {strategy} ==")
        h = run_federated(
            init, apply, loss, topology, xs, ys, x_test, y_test,
            FLConfig(strategy=strategy, rounds=rounds, num_clusters=clusters,
                     snr_db=40.0, eval_samples=eval_samples),
            progress=lambda r, l, a: print(
                f"  round {r:2d}  loss={l:.3f}  acc={a:.3f}"),
            draws=None if draws is None else draws(), device=device)
        print(f"  final accuracy: {h['final_acc']:.3f}\n")
        histories[strategy] = h
    return {"plan": plan, "channel_uses": uses, "histories": histories}


def main(argv=None) -> dict:
    """The JAX quickstart's setup — K=16 clients around 3 hotspots, the
    6,000 / 1,500 mnist-like set split IID, the MNIST MLP, 40 dB — drawn
    from torch generators (seeds 0, 1, 2) on the device, then
    :func:`run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    topology = make_topology(0, TopologyConfig(num_clients=K,
                                               num_hotspots=3),
                             device=device)
    first = int(torch.randint(K, (), generator=torch.Generator()
                              .manual_seed(0)))
    cfg = SyntheticImageConfig.mnist_like(num_train=6000, num_test=1500)
    (xtr, ytr), (xte, yte) = make_synthetic_images(1, cfg, device=device)
    xs, ys = partition_iid(2, xtr, ytr, K)
    return run(topology, (xs, ys, xte, yte), first=first,
               rounds=args.rounds, device=device)


if __name__ == "__main__":
    main()
