"""The benchmark's spans and the reduction of a profiler trace.

`span` marks a call of the benchmark into a layer of the program as a
``torch.profiler.record_function`` range (``portbench.<name>``), beside
the program's own ``PhaseTimers`` ranges (``trace_compile``,
``execute``).  `capture` profiles a block with CPU and CUDA activity and
reduces the trace in memory from the raw events of the profiler's
results (``kineto_results.events()``): nothing is written to disk.
"""
from __future__ import annotations

import contextlib
from typing import Optional

WINDOW = "portbench.traced"


@contextlib.contextmanager
def span(name: str):
    from torch.profiler import record_function

    with record_function("portbench." + name):
        yield


def _raw_events(prof):
    """``(name, kind, start_ns, end_ns)`` of every raw event of the
    profiler's results, ``kind`` one of ``kernel``, ``memcpy``,
    ``memset``, ``device_annotation``, ``annotation`` (a host range of
    ``record_function``) or ``cpu``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        # Some builds (torch 2.11) have no ``activity_type``: the name and
        # the device then decide the kind.
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        kind = _kind(e.name(), str(e.device_type()), act)
        out.append((e.name(), kind, start, start + e.duration_ns()))
    return out


HOST_RANGES = ("trace_compile", "execute")


def _kind(name: str, device: str, activity: str) -> str:
    activity = activity.lower()
    ranged = name.startswith("portbench.") or name in HOST_RANGES
    if "cuda" in device.lower():
        if "annotation" in activity or ranged:
            return "device_annotation"     # a host range's device shadow
        if "memcpy" in activity or name.startswith("Memcpy"):
            return "memcpy"
        if "memset" in activity or name.startswith("Memset"):
            return "memset"
        return "kernel"
    if "annotation" in activity or ranged:
        return "annotation"
    return "cpu"


def _union(intervals):
    """Sorted, merged ``[start, end]`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof) -> Optional[dict]:
    """The traced window's device activity: its length and busy time
    (the union of every device operation's interval inside it), the
    kernels recorded (a count and, by name, count and seconds), the ten
    device operations that took most time and the ten longest idle gaps,
    each labelled by the innermost host range around its middle."""
    events = _raw_events(prof)
    windows = [(s, e) for n, k, s, e in events
               if k == "annotation" and n == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in events
              if k in ("kernel", "memcpy", "memset") and e > w0 and s < w1]
    busy = _union([(s, e) for _, _, s, e in device])
    by_name: dict = {}
    for n, k, s, e in device:
        c, t = by_name.get(n, (0, 0))
        by_name[n] = (c + 1, t + (e - s))
    ranges = [(n, s, e) for n, k, s, e in events
              if k == "annotation" and n != WINDOW]
    gaps, cursor = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)

    def label(t):
        inside = [(e - s, n) for n, s, e in ranges if s <= t < e]
        return min(inside)[1] if inside else "outside any span"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": sum(1 for _, k, _, _ in device if k == "kernel"),
        "by_name": {n: (c, t / 1e9) for n, (c, t) in by_name.items()},
        "device_ops": [[n, t / 1e9] for n, (c, t) in
                       sorted(by_name.items(), key=lambda x: -x[1][1])[:10]],
        "idle_gaps": [[label((s + e) // 2), (e - s) / 1e9]
                      for s, e in longest],
    }


@contextlib.contextmanager
def capture():
    """Profile the block (CPU and CUDA activity) inside the window span;
    yields a dict that holds the reduced trace (`reduce`) afterwards
    under ``"trace"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out: dict = {}
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    out["trace"] = reduce(prof)


def kernel_stats(trace: dict, fragment: str):
    """``(launches, mean seconds)`` of the kernels whose name holds
    ``fragment``, or None if the trace recorded none."""
    hits = [(c, t) for n, (c, t) in trace["by_name"].items()
            if fragment in n]
    count = sum(c for c, _ in hits)
    if not count:
        return None
    return count, sum(t for _, t in hits) / count
