"""repro_torch.obs — observability (port of `repro.obs`): per-round
telemetry (after the run and live), run manifests, JSONL sinks, the
channel-use ledger, the alert monitor, and profiling hooks.

`RoundTelemetry` rides the engine's round when ``telemetry=True`` (a flag
fixed for the run, bit-neutral when off); `RoundStream` drains it to the
host while the run goes on (`stream.LiveTap`, `stream.emit_sweep`), with
`Monitor` alert rules checking the paper's c/T and eq. (5) envelopes in
flight; `build_manifest` stamps provenance, `JsonlSink`/`write_history`
persist a run's event stream, and ``examples/obs_report_torch.py`` /
``examples/watch_run.py`` render it after the run / live.
"""
from repro_torch.obs.ledger import (per_round_table, symbols_per_round,
                                    uses_per_round)
from repro_torch.obs.manifest import (build_manifest, config_hash,
                                      device_info, git_revision, to_jsonable)
from repro_torch.obs.monitor import (Alert, AlertRule, ConsensusDriftRule,
                                     ConvergenceStallRule, Monitor,
                                     NonFiniteLossRule, PowerBudgetRule,
                                     QuarantineRateRule, default_rules)
from repro_torch.obs.profiling import PhaseTimers, profiler_trace
from repro_torch.obs.sink import JsonlSink, read_run, write_history
from repro_torch.obs.stream import (JsonlStreamSink, LiveTap, MemorySink,
                                    PrometheusSink, RoundStream, emit_sweep)
from repro_torch.obs.telemetry import (RoundTelemetry, build_round_telemetry,
                                       init_ledger, per_client_dim,
                                       stacked_consensus_drift)
