"""The live telemetry stream (port of `repro.obs.stream`).

`repro_torch.obs.telemetry` makes every round observable, but only after
the run: `RoundTelemetry` rides the round's outputs.  This module drains
the same records to the host while the run goes on.  Its host side is
JAX's, copied: :class:`RoundStream`, a bounded ring buffer of raw numpy
records (bitwise comparable against the post-hoc telemetry) fanned out
to pluggable sinks — :class:`MemorySink` for tests, JSONL append
(tail-able mid-run by ``examples/watch_run.py``), and a Prometheus-style
textfile — with an optional `repro_torch.obs.monitor.Monitor` evaluating
alert rules on every record.

JAX's traced taps (``io_callback`` inside the scan) have no counterpart
in a captured CUDA graph; the engine emits instead:

* **one trajectory, live** (:class:`LiveTap`): after each round the
  round's copied-out record goes to pinned host memory with
  ``non_blocking=True`` and a CUDA event is recorded behind it; before
  each later round the tap hands the stream every record whose event has
  completed (``Event.query()``, never a wait), and at each checkpoint
  boundary and at the end of the run all of them.  Records arrive in
  round order with absolute round indices, so a resumed run continues
  its stream; no host sync happens inside the run's rounds;
* **a sweep, after the run** (:func:`emit_sweep`): one record per
  trajectory and round, tagged ``(seed, snr_db, round)``, as JAX's
  post-scan ``stream_trajectory_tap`` emits them.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.manifest import to_jsonable
from repro_torch.utils.nest import nest_map

STREAM_SCHEMA = "repro.obs.stream/v1"


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

class MemorySink:
    """Keeps every record as-is (numpy payloads preserved) — the bitwise
    fixture for tests; no serialization loss."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass

    def of_type(self, kind: str) -> list[dict]:
        return [r for r in self.records if r.get("type") == kind]


class JsonlStreamSink:
    """Append-only JSONL, one json object per line, flushed per record so
    ``examples/watch_run.py`` (or plain ``tail -f``) can follow the run
    mid-flight.  ``append=True`` reopens an existing stream — the resume
    path: a resumed run keeps appending to the same file and the absolute
    round tags keep the stream monotone."""

    def __init__(self, path, append: bool = False):
        self.path = str(path)
        self._f = open(self.path, "a" if append else "w")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(to_jsonable(record)) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class PrometheusSink:
    """Prometheus-style textfile exporter: rewrites ``path`` atomically on
    every record with the latest gauge per (seed, snr) trajectory plus a
    cumulative alert counter — point node_exporter's textfile collector
    (or a test) at it."""

    _GAUGES = (
        ("round", "last streamed round (1-based)"),
        ("train_loss", "streamed mean train loss"),
        ("test_acc", "streamed test accuracy"),
        ("participants", "effective transmit-side participation"),
        ("consensus_drift_max", "max per-site ||theta_c - theta_bar||"),
        ("cum_channel_uses", "cumulative OTA channel uses"),
        ("cum_symbols", "cumulative scalar symbols"),
    )

    def __init__(self, path, prefix: str = "repro"):
        self.path = str(path)
        self.prefix = prefix
        self._latest: dict[tuple, dict] = {}
        self._alerts = 0
        self._flush()

    def write(self, record: dict) -> None:
        kind = record.get("type")
        if kind == "alert":
            self._alerts += 1
        elif kind == "stream":
            key = (record.get("seed"), record.get("snr_db"))
            tele = record.get("telemetry") or {}
            drift = np.asarray(tele.get("consensus_drift", np.nan))
            self._latest[key] = {
                "round": record.get("round"),
                "train_loss": record.get("train_loss"),
                "test_acc": record.get("test_acc"),
                "participants": tele.get("participants"),
                "consensus_drift_max": (float(np.max(drift))
                                        if drift.size else None),
                "cum_channel_uses": tele.get("cum_channel_uses"),
                "cum_symbols": tele.get("cum_symbols"),
            }
        else:
            return
        self._flush()

    def _label(self, key: tuple) -> str:
        seed, snr = key
        parts = []
        if seed is not None:
            parts.append(f'seed="{seed}"')
        if snr is not None:
            parts.append(f'snr_db="{snr:g}"')
        return "{" + ",".join(parts) + "}" if parts else ""

    def _flush(self) -> None:
        lines = []
        for name, help_txt in self._GAUGES:
            metric = f"{self.prefix}_{name}"
            lines.append(f"# HELP {metric} {help_txt}")
            lines.append(f"# TYPE {metric} gauge")
            for key, vals in sorted(self._latest.items(),
                                    key=lambda kv: repr(kv[0])):
                v = vals.get(name)
                if v is None:
                    continue
                lines.append(f"{metric}{self._label(key)} {float(v):g}")
        metric = f"{self.prefix}_alerts_total"
        lines.append(f"# HELP {metric} alert records emitted")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {self._alerts}")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, self.path)

    def close(self) -> None:
        self._flush()


# ---------------------------------------------------------------------------
# the host-side stream
# ---------------------------------------------------------------------------

def _np_tree(obj):
    """Materialize a payload nest as nested plain dicts of numpy arrays
    (bit-preserving; no float round-trips); tensors are copied to the
    host."""
    if isinstance(obj, dict):
        return {k: _np_tree(v) for k, v in obj.items()}
    if hasattr(obj, "_asdict"):
        return _np_tree(obj._asdict())
    if isinstance(obj, (list, tuple)):
        return [_np_tree(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().copy()
    return np.asarray(obj)


def _tree_index(obj, t: int):
    """Slice index ``t`` off every leaf's leading (round) axis of a
    materialized payload tree."""
    if isinstance(obj, dict):
        return {k: _tree_index(v, t) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tree_index(v, t) for v in obj]
    return obj[t]


class RoundStream:
    """The host end of the live stream: bounded ring buffer + sink
    fan-out + optional alert monitor.

    The engine hands it each round's record through :class:`LiveTap`
    (one trajectory, while it runs) or :func:`emit_sweep` (a sweep, after
    it), which call :meth:`_emit` / :meth:`_emit_trajectory` with the
    round's tags and telemetry.  They must never raise into the run, so
    sink failures are swallowed into ``self.errors``.

    ``capacity`` bounds the ring (old records drop; sinks saw them
    already).  ``scope_to_trajectories`` restricts the stream to an
    explicit ``(seed, snr)`` allow-list — how the mc-sharded path
    implements rank-0 emit.  ``should_abort``
    re-exports the monitor's escalation decision; the engine's
    checkpointed drivers poll it at segment boundaries
    (checkpoint-then-stop, resumable).
    """

    def __init__(self, sinks: Sequence = (), monitor=None,
                 capacity: int = 4096):
        self.sinks = list(sinks)
        self.monitor = monitor
        self.ring: deque = deque(maxlen=int(capacity))
        self.errors: list[str] = []
        self.emitted = 0
        self.dropped = 0
        self._scope: Optional[set] = None
        self._lock = threading.Lock()

    # -- configuration ------------------------------------------------

    def scope_to_trajectories(self, tags) -> None:
        """Keep only records whose ``(seed, snr_db)`` is in ``tags``
        (snr ``None`` matches the no-sweep tap).  Used by
        `monte_carlo_sharded` to scope the stream to rank 0's chunk."""
        self._scope = {(int(s), None if q is None else float(np.float32(q)))
                       for s, q in tags}

    # -- record intake ------------------------------------------------

    def _emit(self, payload) -> None:
        """One round's record (the live tap of one trajectory)."""
        try:
            p = _np_tree(payload)
            tags = self._tags(p)
            if tags is None:
                with self._lock:
                    self.dropped += 1
                return
            self._ingest(self._round_record(
                tags, int(p["t"]), p["loss"], p["acc"], p["tele"]))
        except Exception as e:  # never poison the running computation
            self.errors.append(repr(e))

    def _emit_trajectory(self, payload) -> None:
        """One trajectory's records after a sweep: ``loss``/``acc``/
        ``tele`` arrive round-stacked (T leading) and expand into T round
        records."""
        try:
            p = _np_tree(payload)
            tags = self._tags(p)
            if tags is None:
                with self._lock:
                    self.dropped += 1
                return
            T = int(np.asarray(p["loss"]).shape[0])
            for t in range(T):
                self._ingest(self._round_record(
                    tags, t, p["loss"][t], p["acc"][t],
                    _tree_index(p["tele"], t)))
        except Exception as e:
            self.errors.append(repr(e))

    def _tags(self, p) -> Optional[tuple]:
        """(seed, snr_db) of a materialized payload, or ``None`` when the
        record must drop (nonzero rank / outside the trajectory scope)."""
        if int(p["rank"]) != 0:
            return None
        snr = float(p["snr"])
        snr_db = None if np.isnan(snr) else snr
        seed = int(p["seed"])
        if self._scope is not None and (seed, snr_db) not in self._scope:
            return None
        return seed, snr_db

    def _round_record(self, tags, t: int, loss, acc, tele) -> dict:
        seed, snr_db = tags
        return {
            "type": "stream",
            "schema": STREAM_SCHEMA,
            "round": int(t) + 1,
            "seed": seed,
            "snr_db": snr_db,
            "train_loss": loss,
            "test_acc": acc,
            "telemetry": tele,
        }

    def _ingest(self, rec: dict) -> None:
        with self._lock:
            self.emitted += 1
            self.ring.append(rec)
            self._write(rec)
            if self.monitor is not None:
                for alert in self.monitor.observe(rec):
                    self._write(alert.to_record())

    def _write(self, rec: dict) -> None:
        for sink in self.sinks:
            try:
                sink.write(rec)
            except Exception as e:  # pragma: no cover - sink failure
                self.errors.append(repr(e))

    # -- host-side inspection -----------------------------------------

    def records(self) -> list[dict]:
        with self._lock:
            return list(self.ring)

    def for_trajectory(self, seed: Optional[int] = None,
                       snr_db: Optional[float] = None) -> list[dict]:
        """Records for one trajectory, sorted by round (a sweep's
        records interleave trajectories)."""
        out = [r for r in self.records()
               if (seed is None or r["seed"] == seed)
               and (snr_db is None or r["snr_db"] == snr_db)]
        return sorted(out, key=lambda r: r["round"])

    @property
    def should_abort(self) -> bool:
        return self.monitor is not None and self.monitor.should_abort

    @property
    def escalates(self) -> bool:
        """True when the attached monitor may request an abort — callers
        must then provide checkpoint machinery to stop into."""
        return (self.monitor is not None
                and getattr(self.monitor, "abort_on_alert", False))

    def close(self) -> None:
        for sink in self.sinks:
            try:
                sink.close()
            except Exception as e:  # pragma: no cover
                self.errors.append(repr(e))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# the engine's emission
# ---------------------------------------------------------------------------

def _payload(seed, snr_db, rank, loss, acc, tele) -> dict:
    """A record's payload in JAX's tap layout: the tags (``snr`` NaN when
    the run has no SNR override) and the round's values."""
    return {"seed": np.int32(seed),
            "snr": np.float32(np.nan if snr_db is None else snr_db),
            "rank": np.int32(rank), "loss": loss, "acc": acc, "tele": tele}


class LiveTap:
    """The live emission of one trajectory's rounds into ``stream``.

    :meth:`push` takes a round's record (its loss, accuracy and
    `RoundTelemetry`, tensors the round has already copied out) and
    starts its copy to pinned host memory behind a CUDA event;
    :meth:`poll` ingests, in round order, the records whose copies have
    completed, without waiting; :meth:`drain` waits for and ingests the
    rest.  On the CPU a record is ingested as it is pushed.  ``rank``:
    the process's rank in a client-sharded run (a record of a nonzero
    rank drops, as JAX's host drops it)."""

    def __init__(self, stream: RoundStream, *, seed: int,
                 snr_db: Optional[float], device, rank: int = 0):
        self.stream, self.seed, self.snr_db = stream, seed, snr_db
        self.rank = rank
        self.cuda = torch.device(device).type == "cuda"
        self._pending: deque = deque()

    def push(self, t: int, loss, acc, tele) -> None:
        """Round ``t``'s (absolute, 0-based) record."""
        record = {"loss": loss, "acc": acc, "tele": tele}
        if not self.cuda:
            self._ingest(t, record)
            return

        def to_host(x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x, non_blocking=True)

        host = nest_map(to_host, record)
        done = torch.cuda.Event()
        done.record()
        self._pending.append((t, host, done))

    def poll(self) -> None:
        """Ingest the front records whose copies have landed."""
        while self._pending and self._pending[0][2].query():
            t, host, _ = self._pending.popleft()
            self._ingest(t, host)

    def drain(self) -> None:
        """Wait for every pushed record and ingest it."""
        while self._pending:
            t, host, done = self._pending.popleft()
            done.synchronize()
            self._ingest(t, host)

    def _ingest(self, t: int, record: dict) -> None:
        self.stream._emit({"t": np.int32(t), **_payload(
            self.seed, self.snr_db, self.rank, record["loss"],
            record["acc"], record["tele"])})


def emit_sweep(stream: RoundStream, seeds: Sequence[int],
               snrs: Sequence[Optional[float]], loss, acc, tele,
               rank: int = 0) -> None:
    """A finished sweep's records: trajectory b is seed ``seeds[b]`` at
    ``snrs[b]``, its ``loss``/``acc`` (B, T) rows and ``tele`` (B, T, ...)
    leaves; one record per trajectory and round, tagged (seed, snr_db,
    round).  ``rank``: the emitting process's rank in a sharded sweep (a
    nonzero rank's trajectories drop)."""
    host = nest_map(lambda x: x.detach().cpu(),
                    {"loss": loss, "acc": acc, "tele": tele})
    for b, (seed, snr_db) in enumerate(zip(seeds, snrs)):
        row = nest_map(lambda x: x[b], host)
        stream._emit_trajectory(_payload(seed, snr_db, rank, row["loss"],
                                         row["acc"], row["tele"]))
