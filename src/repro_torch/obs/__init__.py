"""repro_torch.obs — the port's observability hooks (of `repro.obs`, so
far its profiling: phase timers and a profiler context)."""
from repro_torch.obs.profiling import PhaseTimers, profiler_trace
