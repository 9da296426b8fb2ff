"""Whole runs of every cell at a CPU size: the reference against the
program's CPU route, the result line, and each fault the timed path can
have turning ``correct`` false."""
import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from portbench import control, harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_root, cpu_threads):
    cell = harness.load_cell(tiny_root, name)
    result = harness.run_cell(cell, 2 ** 31 + 17, 0.01, False, "cpu",
                              time.perf_counter())
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name_, check in result["checks"].items():
        assert check["value"] <= check["limit"], name_


@pytest.mark.parametrize("name", ["mnist-cwfl-scan", "mnist-churn-sweep"])
def test_traced_run_reports_per_layer_metrics(name, tiny_root, cpu_threads):
    """On the CPU the trace holds no device kernel, so only the metrics
    read from the host (capture, MFU's arithmetic) are reported."""
    cell = harness.load_cell(tiny_root, name)
    result = harness.run_cell(cell, 3, 0.01, True, "cpu", time.perf_counter())
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert any(k.startswith("capture_s") for k in result["metrics"])
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_turns_correct_false(name, fault, tiny_root, cpu_threads):
    cell = harness.load_cell(tiny_root, name)
    with control.planted(fault):
        result = harness.run_cell(cell, 9, 0.01, False, "cpu",
                                  time.perf_counter())
    assert result["correct"] is False, result["checks"]


def test_run_without_a_card_prints_nothing():
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"},
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_outside_a_checkout_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``portbench/``,
    the program is missing: the run exits non-zero and prints nothing."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300,
                       env={"PATH": "/usr/bin", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
