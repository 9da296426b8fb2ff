"""Figure 2: accuracy vs communication rounds — IID and non-IID,
MNIST-like and CIFAR-like, CWFL-{3,4} vs COTAF (+FedAvg upper bound).
Twin of the JAX package's ``benchmarks/fig2_accuracy.py``."""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.paper.common import BenchScale, run_setting

SETTINGS = [
    # (dataset, iid, strategy, clusters, prox, label)
    ("mnist", True, "cwfl", 3, 0.0, "CWFL-3"),
    ("mnist", True, "cwfl", 4, 0.0, "CWFL-4"),
    ("mnist", True, "cotaf", 3, 0.0, "COTAF"),
    ("mnist", True, "fedavg", 3, 0.0, "FedAvg(ideal)"),
    ("mnist", False, "cwfl", 3, 0.0, "CWFL-3"),
    ("mnist", False, "cwfl", 3, 0.1, "CWFL-3-Prox"),
    ("mnist", False, "cotaf", 3, 0.0, "COTAF"),
    ("cifar", True, "cwfl", 3, 0.0, "CWFL-3"),
    ("cifar", True, "cotaf", 3, 0.0, "COTAF"),
    ("cifar", False, "cwfl", 3, 0.0, "CWFL-3"),
    ("cifar", False, "cwfl", 3, 0.1, "CWFL-3-Prox"),
    ("cifar", False, "cotaf", 3, 0.0, "COTAF"),
]


def run(scale: BenchScale, out_path=None, subset=None, device=None
        ) -> list[dict]:
    """The curves of ``SETTINGS`` (the first ``subset`` of them) on
    ``device`` (``None`` = the GPU), written as JSON to ``out_path`` if
    one is given."""
    rows = []
    settings = SETTINGS if subset is None else SETTINGS[:subset]
    for ds, iid, strat, C, prox, label in settings:
        h = run_setting(ds, iid, strat, scale, num_clusters=C, mu_prox=prox,
                        device=device)
        rows.append({
            "dataset": ds, "iid": iid, "label": label,
            "acc_curve": h["test_acc"], "avg_acc": h["avg_acc"],
            "final_acc": h["final_acc"],
            "seconds_per_round": h["seconds_per_round"],
        })
        print(f"  fig2 {ds} {'iid' if iid else 'noniid'} {label}: "
              f"final={h['final_acc']:.3f} avg={h['avg_acc']:.3f}")
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(rows, indent=1))
    return rows
