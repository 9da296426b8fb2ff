"""Tests of the port's benchmark, on the CPU at small sizes.

    PYTHONPATH=src python -m pytest -q portbench/tests

A test that needs the card carries the ``card`` marker and decides inside
the test whether to skip.  ``tiny_root`` is a throwaway checkout: the
benchmark's files with each cell's configuration cut to a few clients,
samples and rounds, so a whole run fits the CPU in seconds.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"mlp": dict(clients=8, num_train=1600, num_test=400,
                    eval_samples=256, shards_per_client=2, num_shards=16,
                    batch_size=32, rounds=3),
        "cnn": dict(clients=4, num_train=800, num_test=200,
                    eval_samples=128, shards_per_client=2, num_shards=8,
                    batch_size=32, rounds=2)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark under ``dest`` with every configuration
    and sweep cut to a CPU-sized run (the widths' count of clients,
    samples and rounds; the sweeps to 2 seeds)."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["model"]])
        path.write_text(json.dumps(cfg))
    for path in (dest / "portbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "seeds" in t:
            t["seeds"] = 2
        path.write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cpu_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
