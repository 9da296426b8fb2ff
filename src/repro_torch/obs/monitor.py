"""Alert rules over the live telemetry stream (port of
`repro.obs.monitor`, which is numpy only: copied, not imported).

The paper gives reference envelopes, not just metrics: Thm. 1 guarantees
per-cluster O(1/T) convergence, and eq. (5) water-fills the
per-channel-use transmit power against an explicit budget.  A monitor
checks a run against the theory while it is in flight.  Each rule
consumes the stream records `repro_torch.obs.stream.RoundStream` emits and
produces structured :class:`Alert` records — ``(rule, round, trajectory,
value, threshold)`` — written back to the same sinks, so a tailed JSONL
carries both the telemetry and the judgments on it.

Rules (all per-trajectory, keyed by the record's ``(seed, snr_db)``):

* ``non_finite_loss``   — train/cluster loss went NaN/inf;
* ``consensus_drift``   — max ‖θ_c − θ̄‖ exceeded an absolute ceiling or
  blew up relative to its first observed value;
* ``quarantine_rate``   — fraction of clients the divergence guard has
  quarantined (``fault_quarantined`` extra) crossed a threshold;
* ``power_budget``      — eq. (5): the CWFL per-channel-use transmit
  power ``power_budget_frac`` (Σ tx_power / P_total per use) exceeded
  its budget (tolerance ×1.05 for float slack);
* ``convergence_stall`` — fits the running loss history against the
  paper's envelope  loss(t) ≈ a + c/t  by least squares on the basis
  [1, 1/t] and alerts when (a) the latest loss sits far above the fit
  (relative to the trajectory's observed loss range) or (b) the fitted
  decay coefficient c is negative while the loss is rising.

Escalation: ``Monitor(abort_on_alert=True)`` (or a tuple of rule names)
raises ``should_abort`` once a matching alert fires; the engine's
checkpointed driver polls it between segments and stops after saving
the checkpoint — the run resumes exactly where it aborted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Optional, Sequence, Union

import numpy as np

ALERT_SCHEMA = "repro.obs.alert/v1"


@dataclasses.dataclass
class Alert:
    """One structured rule violation."""

    rule: str
    round: int
    trajectory: dict            # {"seed": int|None, "snr_db": float|None}
    value: float
    threshold: float
    message: str

    def to_record(self) -> dict:
        return {"type": "alert", "schema": ALERT_SCHEMA,
                **dataclasses.asdict(self)}


def _traj_key(rec: dict) -> tuple:
    return (rec.get("seed"), rec.get("snr_db"))


def _traj_tag(rec: dict) -> dict:
    return {"seed": rec.get("seed"), "snr_db": rec.get("snr_db")}


class AlertRule:
    """Base rule: stateful per trajectory, fed one stream record at a
    time (arrival order may interleave trajectories; rules index state
    by the record's tags)."""

    name = "base"

    def observe(self, rec: dict) -> list[Alert]:  # pragma: no cover
        raise NotImplementedError

    def _alert(self, rec: dict, value, threshold, message: str) -> Alert:
        return Alert(rule=self.name, round=int(rec["round"]),
                     trajectory=_traj_tag(rec), value=float(value),
                     threshold=float(threshold), message=message)


class NonFiniteLossRule(AlertRule):
    """train_loss or any per-site cluster loss went NaN/±inf."""

    name = "non_finite_loss"

    def observe(self, rec: dict) -> list[Alert]:
        vals = [("train_loss", np.asarray(rec["train_loss"], np.float64))]
        tele = rec.get("telemetry") or {}
        if "cluster_loss" in tele:
            vals.append(("cluster_loss",
                         np.asarray(tele["cluster_loss"], np.float64)))
        out = []
        for label, v in vals:
            if not np.all(np.isfinite(v)):
                bad = float(np.asarray(v).ravel()[
                    int(np.argmin(np.isfinite(np.asarray(v).ravel())))])
                out.append(self._alert(
                    rec, bad, 0.0,
                    f"{label} is non-finite at round {rec['round']}"))
        return out


class ConsensusDriftRule(AlertRule):
    """max ‖θ_site − θ̄‖ over an absolute ceiling, or blown up by
    ``blowup``× relative to the trajectory's first observed drift."""

    name = "consensus_drift"

    def __init__(self, max_drift: float = 100.0, blowup: float = 50.0):
        self.max_drift = float(max_drift)
        self.blowup = float(blowup)
        self._baseline: dict[tuple, float] = {}

    def observe(self, rec: dict) -> list[Alert]:
        tele = rec.get("telemetry") or {}
        if "consensus_drift" not in tele:
            return []
        drift = float(np.max(np.asarray(tele["consensus_drift"],
                                        np.float64)))
        if not math.isfinite(drift):
            return []  # non_finite_loss covers NaN blowups
        key = _traj_key(rec)
        base = self._baseline.setdefault(key, drift)
        out = []
        if drift > self.max_drift:
            out.append(self._alert(
                rec, drift, self.max_drift,
                f"consensus drift {drift:.3g} over ceiling "
                f"{self.max_drift:.3g}"))
        elif base > 1e-9 and drift > self.blowup * base:
            out.append(self._alert(
                rec, drift, self.blowup * base,
                f"consensus drift {drift:.3g} is {drift / base:.1f}x its "
                f"round-1 baseline {base:.3g}"))
        return out


class QuarantineRateRule(AlertRule):
    """Divergence-guard quarantines (`repro_torch.sim.faults`) exceed a
    fraction of the client population.  Silent when the run carries no
    fault plane (no ``fault_quarantined`` extra)."""

    name = "quarantine_rate"

    def __init__(self, max_rate: float = 0.5):
        self.max_rate = float(max_rate)

    def observe(self, rec: dict) -> list[Alert]:
        extras = (rec.get("telemetry") or {}).get("extras") or {}
        if "fault_quarantined" not in extras:
            return []
        quarantined = float(np.asarray(extras["fault_quarantined"]))
        alive = extras.get("fault_alive")
        if alive is not None and np.asarray(alive).ndim:
            total = float(np.asarray(alive).shape[-1])
        else:
            total = float(np.asarray(rec["telemetry"]["participants"])
                          + quarantined)
        if total <= 0:
            return []
        rate = quarantined / total
        if rate > self.max_rate:
            return [self._alert(
                rec, rate, self.max_rate,
                f"{int(quarantined)}/{int(total)} clients quarantined "
                f"({rate:.0%} > {self.max_rate:.0%})")]
        return []


class PowerBudgetRule(AlertRule):
    """eq. (5): per-channel-use transmit power over budget.  CWFL's
    telemetry extras report ``power_budget_frac`` = Σ_k tx_power_k /
    P_total per use; the water-filling solution keeps it ≤ 1, so any
    excursion past ``tol`` means the precoder broke its constraint."""

    name = "power_budget"

    def __init__(self, tol: float = 1.05):
        self.tol = float(tol)

    def observe(self, rec: dict) -> list[Alert]:
        extras = (rec.get("telemetry") or {}).get("extras") or {}
        if "power_budget_frac" not in extras:
            return []
        frac = float(np.max(np.asarray(extras["power_budget_frac"],
                                       np.float64)))
        if frac > self.tol:
            return [self._alert(
                rec, frac, self.tol,
                f"eq.(5) transmit power at {frac:.3f}x budget "
                f"(tol {self.tol:.2f})")]
        return []


class ConvergenceStallRule(AlertRule):
    """Fit loss(t) ≈ a + c/t (Thm. 1's O(1/T) envelope) over the
    trajectory's streamed history; alert when the run stopped tracking
    it.  Uses least squares on the basis [1, 1/t] (t 1-based), needs
    ``min_rounds`` points, and normalizes the residual by the observed
    loss range so converged-flat trajectories never fire."""

    name = "convergence_stall"

    def __init__(self, min_rounds: int = 6, rel_tol: float = 0.5,
                 min_range: float = 1e-4):
        self.min_rounds = int(min_rounds)
        self.rel_tol = float(rel_tol)
        self.min_range = float(min_range)
        self._hist: dict[tuple, dict[int, float]] = {}

    def observe(self, rec: dict) -> list[Alert]:
        key = _traj_key(rec)
        hist = self._hist.setdefault(key, {})
        hist[int(rec["round"])] = float(np.asarray(rec["train_loss"],
                                                   np.float64))
        if len(hist) < self.min_rounds:
            return []
        t = np.array(sorted(hist), np.float64)
        y = np.array([hist[int(k)] for k in t], np.float64)
        if not np.all(np.isfinite(y)):
            return []  # non_finite_loss owns that failure
        span = float(y.max() - y.min())
        if span < self.min_range:
            return []  # flat (converged or constant): no stall signal
        basis = np.stack([np.ones_like(t), 1.0 / t], axis=1)
        (a, c), *_ = np.linalg.lstsq(basis, y, rcond=None)
        fit_last = a + c / t[-1]
        resid = float(y[-1] - fit_last)
        out = []
        if resid > self.rel_tol * span:
            out.append(self._alert(
                rec, resid / span, self.rel_tol,
                f"loss {y[-1]:.4g} sits {resid / span:.2f}x the loss range "
                f"above its fitted a+c/t envelope (a={a:.4g}, c={c:.4g})"))
        elif c < 0 and y[-1] > y[0]:
            out.append(self._alert(
                rec, float(c), 0.0,
                f"no O(1/T) decay: fitted c={c:.4g} < 0 with loss rising "
                f"{y[0]:.4g} -> {y[-1]:.4g}"))
        return out


def default_rules(*, max_drift: float = 100.0, drift_blowup: float = 50.0,
                  max_quarantine_rate: float = 0.5,
                  power_tol: float = 1.05, stall_min_rounds: int = 6,
                  stall_rel_tol: float = 0.5) -> list[AlertRule]:
    """The standard rule set; thresholds are generous enough that the
    committed paper-static goldens stay silent (pinned by tests/CI)."""
    return [
        NonFiniteLossRule(),
        ConsensusDriftRule(max_drift=max_drift, blowup=drift_blowup),
        QuarantineRateRule(max_rate=max_quarantine_rate),
        PowerBudgetRule(tol=power_tol),
        ConvergenceStallRule(min_rounds=stall_min_rounds,
                             rel_tol=stall_rel_tol),
    ]


class Monitor:
    """Evaluates a rule set on every stream record; accumulates alerts;
    decides escalation.

    ``abort_on_alert``: ``False`` (observe only), ``True`` (any alert
    escalates) or an iterable of rule names.  The monitor itself never
    stops anything — `repro_torch.sim.engine`'s checkpointed driver polls
    ``should_abort`` between scan segments and perform the
    checkpoint-then-stop."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 abort_on_alert: Union[bool, Iterable[str]] = False):
        self.rules = list(default_rules() if rules is None else rules)
        if isinstance(abort_on_alert, bool):
            self.abort_on_alert: Any = abort_on_alert
        else:
            self.abort_on_alert = frozenset(abort_on_alert)
        self.alerts: list[Alert] = []
        self._abort = False

    def observe(self, rec: dict) -> list[Alert]:
        fired: list[Alert] = []
        for rule in self.rules:
            try:
                fired.extend(rule.observe(rec))
            except Exception as e:  # a broken rule must not kill the run
                fired.append(Alert(
                    rule=f"{rule.name}!error", round=int(rec.get("round", 0)),
                    trajectory=_traj_tag(rec), value=float("nan"),
                    threshold=float("nan"), message=repr(e)))
        self.alerts.extend(fired)
        for a in fired:
            if self.abort_on_alert is True or (
                    not isinstance(self.abort_on_alert, bool)
                    and a.rule in self.abort_on_alert):
                self._abort = True
        return fired

    @property
    def should_abort(self) -> bool:
        return self._abort

    def summary(self) -> dict:
        by_rule: dict[str, int] = {}
        for a in self.alerts:
            by_rule[a.rule] = by_rule.get(a.rule, 0) + 1
        return {"alerts": len(self.alerts), "by_rule": by_rule,
                "aborted": self._abort}
