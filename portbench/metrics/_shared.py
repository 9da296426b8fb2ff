"""Arithmetic the per-layer readers share.  Each reader's ``read(run)``
gets the run's record (`portbench.harness.run_cell`): ``config``,
``traffic``, ``entry``, the unprofiled window's ``window_s``, ``work``
(trajectory-rounds), ``calls`` and ``timers`` (the program's
``PhaseTimers`` seconds over the window), and the profiled call's
``trace`` (`portbench.tracing.reduce`), ``traced_record`` and
``traced_rounds``.  A reader that finds nothing returns None."""
from __future__ import annotations

from portbench import counts, tracing


def launches_per_round(run):
    trace = run["trace"]
    if trace is None or not trace["kernels"]:
        return None
    return trace["kernels"] / run["traced_rounds"]


def capture_s(run):
    seconds = run["timers"].get("trace_compile")
    return None if seconds is None else seconds / run["calls"]


def replay_rate(run):
    """The window's replayed rounds (every round of a call but its eager
    first) over its ``execute`` seconds: the replays' pace, steadier than
    the window's rate, which the host's capture of each call spreads."""
    seconds = run["timers"].get("execute")
    if not seconds:
        return None
    rounds = run["config"]["rounds"]
    return run["work"] * (rounds - 1) / rounds / seconds


def mfu(run):
    flops = counts.flops_per_round(run["config"]) * run["work"]
    return 100.0 * flops / run["window_s"] / counts.PEAK_F32_FLOPS


def idle_pct(run):
    trace = run["trace"]
    if trace is None or trace["window_s"] <= 0 or not trace["kernels"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def cwfl_round_roofline(run):
    trace, cfg = run["trace"], run["config"]
    stats = None if trace is None else tracing.kernel_stats(
        trace, "cwfl_round_kernel")
    if stats is None:
        return None
    B = run["traced_record"].loss.shape[0]
    bound = counts.cwfl_round_bytes(B, cfg["clients"], cfg["clusters"],
                                    counts.params_count(cfg))
    return 100.0 * bound / counts.PEAK_HBM_BYTES_PER_S / stats[1]


def channel_view_roofline(run):
    from portbench.reference.fl import arrivals

    trace, cfg = run["trace"], run["config"]
    stats = None if trace is None else tracing.kernel_stats(
        trace, "channel_round_kernel")
    if stats is None:
        return None
    entry, rec = run["entry"], run["traced_record"]
    draws = entry.trajectory_draws(rec.key)
    per_round = arrivals(cfg, run["traffic"], entry.geometry, draws,
                         run["traced_rounds"], entry.device)
    B, K = len(draws), cfg["clients"]
    mean_bytes = sum(counts.channel_view_bytes(B, K, a)
                     for a in per_round) / len(per_round)
    return 100.0 * mean_bytes / counts.PEAK_HBM_BYTES_PER_S / stats[1]
