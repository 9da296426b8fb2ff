"""The benchmark's harness: finds a cell by name, runs it once, builds the
result line.

Everything about a cell is data that the harness finds by name:

* ``BENCHMARK.json`` (the repository's root) names the cell's
  configuration, traffic mix and chips, and the metrics;
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix (the entry that drives the
  program, the strategy, the scenario, the sweep's seeds and SNRs);
* ``entries/<entry>.py``: one module per entry point of the program;
* ``cells/<workload>.json``: the cell's ``limits``, each number that
  decides ``correct`` with its limit, and ``call_seconds``, how long one
  call of its entry takes on the card, which sets how many calls a
  window makes;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  returning a number or None.

A run: the inputs made on the device from the seed, one warm-up call of
the cell's entry at a few rounds, then a fixed number of calls back to
back for the window (``--seconds`` over ``call_seconds``, at least one:
the work of a window is the same in every run, and so is its memory,
since the program keeps some memory for each call), then (``trace``) one
more call under the profiler, then the reference on a call of the window
drawn from the seed.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """A workload of ``BENCHMARK.json``, its files loaded."""

    def __init__(self, bench: dict, name: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        w = cells[name]
        self.name, self.chips = name, w["chips"]
        self.root = root
        config = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = json.loads((root / config["file"]).read_text())
        self.traffic = json.loads(
            (root / "portbench" / "traffic" / f"{w['traffic']}.json")
            .read_text())
        spec = json.loads((root / "portbench" / "cells" / f"{name}.json")
                          .read_text())
        self.limits, self.call_seconds = spec["limits"], spec["call_seconds"]

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def entry(self):
        return importlib.import_module(
            f"portbench.entries.{self.traffic['entry']}")

    def reader(self, metric: str):
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return Cell(bench, name, root)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def check_rounds(traffic: dict, rounds: int) -> int:
    """The rounds the reference follows: all of a call's, or the first
    ``check_rounds`` of a traffic whose later rounds are chaotic (a
    trajectory at a low SNR amplifies the last bit of a sum until it
    diverges, so two sound programs part there)."""
    return min(rounds, traffic.get("check_rounds", rounds))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> Optional[dict]:
    """One run of ``cell``; returns the result line's object, or None when
    the run must print none (a forbidden module was loaded)."""
    import torch
    from repro_torch.obs.profiling import PhaseTimers

    from portbench import tracing
    from portbench.reference.check import numbers, verdict, worst

    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [time.perf_counter()]
    torch.empty(1, device=device)       # the context, timed on its own
    _sync(device)
    marks.append(time.perf_counter())
    mod = cell.entry()
    entry = mod.Entry(cell.config, cell.traffic, seed, device)
    _sync(device)
    marks.append(time.perf_counter())
    with tracing.span("warmup"):
        entry.run(-1, rounds=cell.traffic["warmup_rounds"],
                  key=("warmup", seed))
    _sync(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t0
    _log("set-up (s): " + " ".join(
        f"{name} {b - a:.3f}" for name, a, b in
        zip(("imports", "context", "inputs", "warmup"), [t0] + marks,
            marks)))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    timers = PhaseTimers() if trace else None
    records, ends = [], []
    start = time.perf_counter()
    for k in range(max(1, round(seconds / cell.call_seconds))):
        with tracing.span("call"):
            records.append(entry.run(k, timers=timers))
        _sync(device)
        ends.append(time.perf_counter())
    window_s = ends[-1] - start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    work = sum(r.work for r in records)
    calls = len(records)
    _log(f"window: {calls} calls, {work} {mod.UNIT} in "
         f"{window_s:.6f} s; calls (s): " + " ".join(
             f"{b - a:.3f}" for a, b in zip([start] + ends, ends)))

    traced = None
    if trace:
        with tracing.capture() as cap:
            with tracing.span("call"):
                rec = entry.run(len(records), timers=PhaseTimers())
        traced = cap["trace"]
        traced_rounds = entry.rounds_of(rec)
        if traced is not None:
            _log(f"trace: {traced['kernels']} kernels recorded over "
                 f"{traced_rounds} rounds, busy {traced['busy_s']:.6f} of "
                 f"{traced['window_s']:.6f} s")
    peak = max(peak, window_peak,
               torch.cuda.max_memory_allocated(device) if cuda else 0)

    # The check: a call of the window drawn from the seed, against the
    # plain reference, once the program's state is gone.
    from portbench import inputs

    pick = records[inputs.stream_seed("check", seed) % len(records)]
    prog = pick.outputs()
    del records
    if cuda:
        torch.cuda.empty_cache()
    with tracing.span("reference"), reference_numerics():
        ref = entry.reference(pick.key, check_rounds(cell.traffic,
                                                          pick.loss.shape[1]))
    values = numbers(prog, ref)
    _log(worst(prog, ref))
    correct, rows = verdict(values, cell.limits)

    metrics = {}
    if not trace:
        e2e = {"setup_s": setup_s, "peak_mem_gb": window_peak / 1e9,
               "rounds_per_s": work / window_s,
               "trajectory_rounds_per_s": work / window_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = {"config": cell.config, "traffic": cell.traffic,
               "entry": entry, "window_s": window_s, "work": work,
               "calls": calls, "timers": timers.seconds, "trace": traced,
               "traced_record": rec, "traced_rounds": traced_rounds}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": calls,
              "failed": 0 if correct else 1,
              "metrics": metrics,
              "device": _device(device, peak, cell.chips)}
    if trace and traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {found}")
        return None
    for name, value, limit in rows:
        _log(f"check {name} {value!r} limit {limit!r}")
    return result


def _device(device, peak: int, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


@contextlib.contextmanager
def reference_numerics(tf32: bool = False):
    """The reference's numerics: f32 matmuls and convolutions with TF32
    off, cuDNN held to its deterministic algorithms; with ``tf32`` (the
    lower-precision control) TF32 on.  The caller's flags back after."""
    import torch

    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved
