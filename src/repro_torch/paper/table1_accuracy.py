"""Table I: average non-IID accuracy — COTAF / COTAF-Prox / CWFL-3 /
CWFL-3-Prox / CWFL-4 (MNIST; CWFL-4 omitted for CIFAR as in the paper).
Twin of the JAX package's ``benchmarks/table1_accuracy.py``."""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.paper.common import BenchScale, run_setting

ROWS = [
    ("COTAF", "cotaf", 3, 0.0),
    ("COTAF-Prox", "cotaf", 3, 0.1),
    ("CWFL-3", "cwfl", 3, 0.0),
    ("CWFL-3-Prox", "cwfl", 3, 0.1),
    ("CWFL-4", "cwfl", 4, 0.0),
]


def run(scale: BenchScale, out_path=None, datasets=("mnist", "cifar"),
        device=None) -> dict:
    """The table on ``device`` (``None`` = the GPU), written as JSON to
    ``out_path`` if one is given."""
    table = {}
    for ds in datasets:
        table[ds] = {}
        for label, strat, C, prox in ROWS:
            if ds == "cifar" and label == "CWFL-4":
                table[ds][label] = None      # paper: '-'
                continue
            h = run_setting(ds, False, strat, scale, num_clusters=C,
                            mu_prox=prox, device=device)
            table[ds][label] = h["avg_acc"]
            print(f"  table1 {ds} {label}: avg={h['avg_acc']:.3f}")
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(table, indent=1))
    return table
