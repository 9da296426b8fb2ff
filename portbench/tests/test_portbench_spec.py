"""``BENCHMARK.json`` and the files the harness finds by name."""
import json
import re
import shutil
import time

import pytest

from conftest import ROOT
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok)")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        spec = json.loads((ROOT / "portbench" / "cells" / f"{w['name']}.json")
                          .read_text())
        assert spec["call_seconds"] > 0 and spec["limits"]
    assert used == set(configs)


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                               cells))
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = harness.load_cell(ROOT, name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.limits
    assert cell.entry().Entry
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


def test_throwaway_cell_added_as_files(tmp_path, cpu_threads):
    """A cell that exists only as new files (a configuration, a traffic
    mix, its cell file, a per-layer metric) is found and run by name."""
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/mnist-mlp.json").read_text())
    cfg.update(name="mnist-mlp-c2", clusters=2, rounds=2)
    (root / "portbench/configs/mnist-mlp-c2.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "portbench/traffic/cwfl-scan.json")
                         .read_text())
    (root / "portbench/traffic/cwfl-scan-short.json").write_text(
        json.dumps(dict(traffic, warmup_rounds=1)))
    shutil.copy(root / "portbench/cells/mnist-cwfl-scan.json",
                root / "portbench/cells/extra-cell.json")
    (root / "portbench/metrics/calls_in_window.py").write_text(
        "def read(run):\n    return float(run['calls'])\n")
    bench["configs"].append({"name": "mnist-mlp-c2", "source": "x",
                             "file": "portbench/configs/mnist-mlp-c2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra-cell", "config": "mnist-mlp-c2",
                               "traffic": "cwfl-scan-short", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "rounds_per_s" == m["name"]:
            m["workloads"].append("extra-cell")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "rounds_per_s",
                               "workloads": ["extra-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root, "extra-cell")
    assert cell.config["clusters"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "calls_in_window"
    result = harness.run_cell(cell, 5, 0.01, True, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_in_window"]["value"] >= 1
