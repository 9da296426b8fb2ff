"""JSONL event/metrics sink (port of `repro.obs.sink`; the JSONL has the
JAX package's schema, so ``examples/obs_report_torch.py`` and
``examples/watch_run.py`` read the port's runs as they read JAX's).

One run = one append-only JSONL stream: a ``manifest`` record first
(`repro_torch.obs.manifest`), one ``round`` record per (trajectory,
round) carrying the metrics and the `RoundTelemetry` fields, and a final
``summary`` record (final accuracies, phase timers).
"""
from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np

from repro_torch.obs.manifest import to_jsonable


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device), array or number as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class JsonlSink:
    """Append-only JSONL writer; one json object per line, flushed per
    record so a crashed run keeps everything emitted so far."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "w")

    def emit(self, kind: str, **fields) -> None:
        rec = {"type": kind, **{k: to_jsonable(v) for k, v in fields.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _tele_at(tele, idx: tuple) -> dict:
    """One (trajectory..., round) record of a stacked telemetry nest, as a
    plain nested dict."""
    d = {k: as_numpy(v)[idx] for k, v in tele._asdict().items()
         if k != "extras"}
    d["extras"] = {k: as_numpy(v)[idx] for k, v in tele.extras.items()}
    return d


def write_history(path, history: dict, manifest: Optional[dict] = None,
                  timings: Optional[dict] = None) -> int:
    """Serialize an engine history (`run_rounds` / `run_monte_carlo`
    output, optionally carrying ``history["telemetry"]``) into a JSONL
    stream at ``path``.  Returns the number of records written.

    Single-trajectory histories emit one ``round`` record per round;
    Monte-Carlo histories emit one per (seed[, snr], round) tagged with
    the trajectory indices and resolved seed/SNR values.
    """
    loss = as_numpy(history["train_loss"])
    acc = as_numpy(history["test_acc"])
    tele = history.get("telemetry")
    seeds = history.get("seeds")
    snr_grid = history.get("snr_grid")
    seeds = None if seeds is None else as_numpy(seeds)
    snr_grid = None if snr_grid is None else as_numpy(snr_grid)

    n = 0
    with JsonlSink(path) as sink:
        if manifest is not None:
            sink.emit("manifest", **manifest)
            n += 1
        T = loss.shape[-1]
        for traj_idx in np.ndindex(loss.shape[:-1]):
            tags: dict[str, Any] = {}
            if traj_idx:
                tags["traj"] = list(traj_idx)
                if seeds is not None:
                    tags["seed"] = int(seeds[traj_idx[0]])
                if snr_grid is not None and len(traj_idx) > 1:
                    tags["snr_db"] = float(snr_grid[traj_idx[1]])
            for t in range(T):
                idx = traj_idx + (t,)
                rec = {"round": t + 1, **tags,
                       "train_loss": float(loss[idx]),
                       "test_acc": float(acc[idx])}
                if tele is not None:
                    rec["telemetry"] = _tele_at(tele, idx)
                sink.emit("round", **rec)
                n += 1
        summary: dict[str, Any] = {
            "rounds": int(T),
            "trajectories": int(np.prod(loss.shape[:-1], dtype=int)),
            "final_acc": to_jsonable(acc[..., -1]),
        }
        if tele is not None:
            summary["cum_channel_uses"] = to_jsonable(
                as_numpy(tele.cum_channel_uses)[..., -1])
            summary["cum_symbols"] = to_jsonable(
                as_numpy(tele.cum_symbols)[..., -1])
        if timings is not None:
            summary["timings"] = timings
        sink.emit("summary", **summary)
        n += 1
    return n


def read_run(path) -> dict:
    """Parse a JSONL run back into ``{"manifest": dict|None,
    "rounds": [..], "summary": dict|None, "events": [..]}``."""
    manifest, rounds, summary, events = None, [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "manifest":
                manifest = rec
            elif kind == "round":
                rounds.append(rec)
            elif kind == "summary":
                summary = rec
            else:
                events.append(rec)
    return {"manifest": manifest, "rounds": rounds, "summary": summary,
            "events": events}
