"""Profiling hooks: phase wall timers and an optional ``torch.profiler``
trace (port of `repro.obs.profiling`, which imports no JAX at its top:
copied, not imported).

`PhaseTimers` splits a run's wall time into the phases that matter for
the engine: ``trace_compile`` (the round run eagerly once, then captured
into a CUDA graph: the counterpart of JAX's trace and compile) and
``execute`` (the replays, to ``torch.cuda.synchronize``).  Each phase is
also a ``torch.profiler.record_function`` range of its name, so a
profiled run shows where the replays begin and end.  Timers are opt-in:
with ``timers=None`` the engine times nothing.

:func:`profiler_trace` wraps a run in ``torch.profiler.profile`` (CPU and,
with a card, CUDA activity) when a directory is given, writing a Chrome
trace there; it is a no-op otherwise.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional


class PhaseTimers:
    """Accumulating named wall timers: ``with timers.phase("execute"):``.
    Re-entering a phase accumulates (loop-mode rounds sum into one
    ``execute`` figure)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield self
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def as_dict(self) -> dict:
        return {k: round(v, 6) for k, v in sorted(self.seconds.items())}


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str] = None):
    """``torch.profiler.profile`` over the block when a directory is given
    (created if needed), its Chrome trace written there as
    ``trace.json``; a no-op context otherwise.  Yields the profiler (or
    ``None``)."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
