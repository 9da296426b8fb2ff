"""The port's live stream and alert monitor (`repro_torch.obs.stream`,
`repro_torch.obs.monitor`), the counterparts of ``tests/test_stream.py``:
the streamed records are, bit for bit, the post-hoc telemetry (one
trajectory live, a sweep after the run, with their tags); a resumed run
continues its stream; an escalating alert checkpoints, then stops; the
monitor's rules, fed the same records as the JAX package's, raise the
same alerts; the JSONL and Prometheus sinks; and ``examples/watch_run.py``
renders the port's JSONL.  Small sizes: K=8, hidden 32, on the CPU."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs import monitor as jmonitor
from repro_torch.obs import (ConsensusDriftRule, ConvergenceStallRule,
                             JsonlStreamSink, MemorySink, Monitor,
                             NonFiniteLossRule, PowerBudgetRule,
                             PrometheusSink, QuarantineRateRule, RoundStream,
                             default_rules)
from repro_torch.obs.stream import _np_tree, _tree_index
from repro_torch.sim import run_monte_carlo, run_rounds
from repro_torch.training import FLConfig
from test_torch_dist import _spawn
from test_torch_resume import EVAL, K, TCFG, _model, data  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wl(data):  # noqa: F811
    return (*_model(), *data)


def _cfg(strategy="cwfl", rounds=2, **kw):
    return FLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                    eval_samples=EVAL, seed=0, **kw)


def _run(wl, cfg, **kw):
    return run_rounds(*wl, cfg, topo_cfg=TCFG, device="cpu", **kw)


def _assert_tree_bitwise(a, b, where=""):
    """Bitwise equality of materialized record trees (dicts and lists of
    numpy arrays), NaN included."""
    if isinstance(a, dict) or isinstance(b, dict):
        assert sorted(a) == sorted(b), f"{where}: {sorted(a)} {sorted(b)}"
        for k in a:
            _assert_tree_bitwise(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_bitwise(x, y, f"{where}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{where}: {a.shape} vs {b.shape}"
    assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                          np.atleast_1d(b).view(np.uint8)), where


def assert_stream_is_posthoc(records, h, rounds, seed=0, snr_db=40.0,
                             first=1):
    """Every streamed record is the post-hoc history's round, bitwise."""
    assert [r["round"] for r in records] == list(range(first,
                                                       first + rounds))
    tele = _np_tree(h["telemetry"])
    loss, acc = h["train_loss"].numpy(), h["test_acc"].numpy()
    for rec in records:
        t = rec["round"] - 1
        assert rec["seed"] == seed and rec["snr_db"] == snr_db
        assert rec["type"] == "stream"
        _assert_tree_bitwise(rec["train_loss"], loss[t], "train_loss")
        _assert_tree_bitwise(rec["test_acc"], acc[t], "test_acc")
        _assert_tree_bitwise(rec["telemetry"], _tree_index(tele, t),
                             f"telemetry[t={t}]")


@pytest.mark.parametrize("strategy,scenario", [
    ("cwfl", None), ("cotaf", None), ("fedavg", "straggler-heavy"),
    ("decentralized", "head-failure")])
def test_stream_is_the_posthoc_telemetry(wl, strategy, scenario):
    cfg = _cfg(strategy, rounds=3)
    ref = _run(wl, cfg, scenario=scenario, telemetry=True)
    sink = MemorySink()
    stream = RoundStream([sink])
    h = _run(wl, cfg, scenario=scenario, telemetry=True, stream=stream)
    for key in ("train_loss", "test_acc"):
        assert torch.equal(h[key], ref[key])
    assert_stream_is_posthoc(stream.records(), h, cfg.rounds)
    assert sink.of_type("stream") == stream.records()
    assert stream.emitted == cfg.rounds and not stream.errors


def test_stream_needs_telemetry_and_the_scan(wl):
    with pytest.raises(ValueError, match="telemetry=True"):
        _run(wl, _cfg(), stream=RoundStream([MemorySink()]))
    with pytest.raises(ValueError, match="loop"):
        _run(wl, _cfg(), telemetry=True, stream=RoundStream(), mode="loop")
    with pytest.raises(ValueError, match="telemetry=True"):
        run_monte_carlo(*wl, _cfg(), seeds=2, device="cpu",
                        stream=RoundStream())


def test_sweep_stream_tags_each_trajectory(wl):
    """After the sweep, one record per (seed, snr_db, round), bitwise the
    sweep's telemetry; the streamed sweep's metrics are the unstreamed
    one's."""
    cfg = _cfg()
    grid = [20.0, 40.0]
    ref = run_monte_carlo(*wl, cfg, seeds=2, snr_grid=grid, device="cpu",
                          telemetry=True)
    stream = RoundStream([MemorySink()])
    h = run_monte_carlo(*wl, cfg, seeds=2, snr_grid=grid, device="cpu",
                        telemetry=True, stream=stream)
    for key in ("train_loss", "test_acc"):
        assert torch.equal(h[key], ref[key])
    assert len(stream.records()) == 2 * 2 * cfg.rounds
    tele = _np_tree(h["telemetry"])
    for s in range(2):
        for g, snr in enumerate(grid):
            recs = stream.for_trajectory(seed=s, snr_db=snr)
            assert [r["round"] for r in recs] == [1, 2]
            for rec in recs:
                t = rec["round"] - 1
                _assert_tree_bitwise(rec["train_loss"],
                                     h["train_loss"][s, g, t].numpy())
                _assert_tree_bitwise(rec["telemetry"], _tree_index(
                    _tree_index(_tree_index(tele, s), g), t))


def test_resume_continues_the_stream(wl, tmp_path):
    """Stopped after round 2 of 4 and resumed: the resumed run streams the
    absolute rounds 3..4, and the two streams together are the
    uninterrupted run's, its cumulative ledger included."""
    cfg = _cfg(rounds=4)
    ref_stream = RoundStream([MemorySink()])
    ref = _run(wl, cfg, telemetry=True, stream=ref_stream)
    ck = str(tmp_path / "ck")
    s1 = RoundStream([MemorySink()])
    _run(wl, cfg, telemetry=True, stream=s1, checkpoint_dir=ck,
         checkpoint_every=1, stop_after=2)
    assert [r["round"] for r in s1.records()] == [1, 2]
    s2 = RoundStream([MemorySink()])
    h = _run(wl, cfg, telemetry=True, stream=s2, checkpoint_dir=ck,
             checkpoint_every=1, resume=True)
    for key in ("train_loss", "test_acc"):
        assert torch.equal(h[key], ref[key])
    assert_stream_is_posthoc(s2.records(), h, 2, first=3)
    merged = s1.records() + s2.records()
    assert len(merged) == len(ref_stream.records()) == 4
    for rec, want in zip(merged, ref_stream.records()):
        _assert_tree_bitwise(rec["telemetry"], want["telemetry"],
                             f"round {rec['round']}")


def test_abort_on_alert_checkpoints_then_stops(wl, tmp_path):
    cfg = _cfg(rounds=4)
    ck = str(tmp_path / "ck")
    mon = Monitor([ConsensusDriftRule(max_drift=1e-9)], abort_on_alert=True)
    stream = RoundStream([MemorySink()], monitor=mon)
    h = _run(wl, cfg, telemetry=True, stream=stream, checkpoint_dir=ck,
             checkpoint_every=1)
    assert stream.should_abort and mon.summary()["aborted"]
    assert h["train_loss"].shape[0] == 1                  # stopped early
    assert (tmp_path / "ck" / "step_00000001" / "arrays.npz").exists()
    assert stream.records() and all(
        a["rule"] == "consensus_drift" for a in
        stream.sinks[0].of_type("alert"))
    h2 = _run(wl, cfg, telemetry=True, stream=RoundStream([MemorySink()]),
              checkpoint_dir=ck, checkpoint_every=1, resume=True)
    assert h2["train_loss"].shape[0] == cfg.rounds
    full = _run(wl, cfg, telemetry=True)
    assert torch.equal(h2["train_loss"], full["train_loss"])


def test_abort_without_a_checkpoint_raises(wl):
    mon = Monitor(default_rules(), abort_on_alert=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(wl, _cfg(), telemetry=True,
             stream=RoundStream([MemorySink()], monitor=mon))


# ---------------------------------------------------------------------------
# The monitor's rules, against JAX's on the same records.
# ---------------------------------------------------------------------------

def _rec(round=1, seed=0, snr_db=40.0, train_loss=2.0, drift=(0.5, 0.6),
         extras=None, **tele):
    telemetry = {"cluster_loss": [2.0, 2.1], "participants": 8.0,
                 "consensus_drift": list(drift), "channel_uses": 9.0,
                 "cum_channel_uses": 9.0 * round, "cum_symbols": 100.0,
                 "reclustered": 0.0, "extras": extras or {}}
    telemetry.update(tele)
    return {"type": "stream", "round": round, "seed": seed,
            "snr_db": snr_db, "train_loss": train_loss, "test_acc": 0.5,
            "telemetry": telemetry}


def _feeds():
    """Record sequences that make each rule fire, and stay silent."""
    nan = float("nan")
    return {
        "non_finite_loss": [_rec(), _rec(round=2, train_loss=nan),
                            _rec(round=3, cluster_loss=[1.0, math.inf])],
        "consensus_drift": [_rec(drift=(0.5,)), _rec(round=2, drift=(30.0,)),
                            _rec(round=1, seed=7, drift=(30.0,)),
                            _rec(round=3, drift=(150.0,))],
        "quarantine_rate": [_rec(), _rec(extras={
            "fault_quarantined": 6.0, "fault_alive": [1.0] * 8}),
            _rec(round=2, extras={"fault_quarantined": 2.0})],
        "power_budget": [_rec(extras={"power_budget_frac": 1.0}),
                         _rec(round=2, extras={"power_budget_frac": 1.2})],
        "convergence_stall": (
            [_rec(round=t, train_loss=1.0 + 3.0 / t) for t in range(1, 11)]
            + [_rec(round=t, seed=1, train_loss=1.0 + 0.3 * t)
               for t in range(1, 11)]
            + [_rec(round=t, seed=2, train_loss=[1.0, 2.0, 1.5, 1.2, 1.1,
                                                 1.05, 4.0][t - 1])
               for t in range(1, 8)]),
    }


def _rules(pkg):
    return [pkg.NonFiniteLossRule(), pkg.ConsensusDriftRule(),
            pkg.QuarantineRateRule(), pkg.PowerBudgetRule(),
            pkg.ConvergenceStallRule()]


@pytest.mark.parametrize("feed", sorted(_feeds()))
def test_monitor_rules_raise_jax_alerts(feed):
    """Each rule fed the same records as JAX's `Monitor`: the same
    alerts, field by field, and the same escalation."""
    from repro_torch.obs import monitor as tmonitor

    records = _feeds()[feed]
    got_mon = Monitor(_rules(tmonitor), abort_on_alert=[feed])
    ref_mon = jmonitor.Monitor(_rules(jmonitor), abort_on_alert=[feed])
    for rec in records:
        got = [a.to_record() for a in got_mon.observe(rec)]
        ref = [a.to_record() for a in ref_mon.observe(rec)]
        assert json.dumps(got, sort_keys=True) == json.dumps(
            ref, sort_keys=True)
    assert any(a.rule == feed for a in got_mon.alerts)
    assert got_mon.should_abort == ref_mon.should_abort is True
    assert got_mon.summary() == ref_mon.summary()


def test_monitor_on_a_real_run_matches_jax(wl):
    """The default rules over a healthy run's stream: silent, as JAX's;
    with a drift ceiling of 1e-9, the same alerts as JAX's."""
    for max_drift, silent in ((100.0, True), (1e-9, False)):
        mon = Monitor(default_rules(max_drift=max_drift))
        stream = RoundStream([MemorySink()], monitor=mon)
        _run(wl, _cfg(rounds=3), telemetry=True, stream=stream)
        ref = jmonitor.Monitor(jmonitor.default_rules(max_drift=max_drift))
        for rec in stream.records():
            ref.observe(rec)
        assert (mon.summary()["alerts"] == 0) is silent
        assert ([a.to_record() for a in mon.alerts]
                == [a.to_record() for a in ref.alerts])


def test_broken_rule_is_contained():
    class Bomb(ConsensusDriftRule):
        name = "bomb"

        def observe(self, rec):
            raise RuntimeError("boom")

    assert [a.rule for a in Monitor([Bomb()]).observe(_rec())] == [
        "bomb!error"]
    assert [a.rule for a in Monitor([NonFiniteLossRule(), PowerBudgetRule(),
                                     QuarantineRateRule(),
                                     ConvergenceStallRule()]).observe(
        _rec())] == []


# ---------------------------------------------------------------------------
# Sinks and the terminal watcher.
# ---------------------------------------------------------------------------

def test_jsonl_sink_appends_and_prometheus_textfile(tmp_path):
    path = tmp_path / "s.jsonl"
    sink = JsonlStreamSink(str(path))
    sink.write({"type": "manifest", "x": 1})
    sink.write(_rec())
    sink.close()
    sink2 = JsonlStreamSink(str(path), append=True)    # a resumed run
    sink2.write(_rec(round=2))
    sink2.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln.get("round") for ln in lines] == [None, 1, 2]

    prom = tmp_path / "s.prom"
    ps = PrometheusSink(str(prom))
    ps.write(_rec(round=3))
    ps.write({"type": "alert", "rule": "power_budget",
              "trajectory": {"seed": 0, "snr_db": 40.0}})
    ps.close()
    text = prom.read_text()
    assert 'repro_round{seed="0",snr_db="40"} 3' in text
    assert "repro_alerts_total 1" in text


def test_watch_run_renders_the_port_jsonl(wl, tmp_path):
    """A streamed run's JSONL, with its alerts: ``--once`` renders it,
    ``--fail-on-alert`` exits 2."""
    path = tmp_path / "live.jsonl"
    sink = JsonlStreamSink(str(path))
    sink.write({"type": "manifest", "strategy": "cwfl"})
    mon = Monitor(default_rules(max_drift=1e-9))
    stream = RoundStream([sink], monitor=mon)
    _run(wl, _cfg(rounds=3), telemetry=True, stream=stream)
    stream.close()
    script = os.path.join(ROOT, "examples", "watch_run.py")
    r = subprocess.run([sys.executable, script, str(path), "--once"],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "round 3" in r.stdout and "cum_uses" in r.stdout
    r = subprocess.run([sys.executable, script, str(path),
                        "--fail-on-alert"], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 2
    assert "consensus_drift" in r.stdout


# ---------------------------------------------------------------------------
# Over a process group: rank-0 emit.
# ---------------------------------------------------------------------------

def _ranks_job(rank, world, p):
    """A client-sharded streamed run and a streamed shard="mc" sweep."""
    wl = (*_model(), *p["data"])
    cfg = _cfg(rounds=2)
    clients = RoundStream([MemorySink()])
    h = run_rounds(*wl, cfg, device="cpu", shard="clients", telemetry=True,
                   stream=clients)
    mc = RoundStream([MemorySink()])
    hm = run_monte_carlo(*wl, cfg, seeds=2, device="cpu", shard="mc",
                         telemetry=True, stream=mc)
    return {"h": h, "records": clients.records(),
            "dropped": clients.dropped, "hm": hm, "mc": mc.records(),
            "mc_dropped": mc.dropped}


def test_rank_zero_emits_over_two_ranks(data, tmp_path):  # noqa: F811
    """Client-sharded: rank 0's records are its post-hoc telemetry, rank
    1's drop.  shard="mc": rank 0's chunk (seed 0) alone is streamed,
    bitwise the gathered telemetry."""
    ranks = _spawn(_ranks_job, 2, {"data": data}, tmp_path)
    zero, one = ranks
    assert_stream_is_posthoc(zero["records"], zero["h"], 2)
    assert one["records"] == [] and one["dropped"] == 2
    assert {r["seed"] for r in zero["mc"]} == {0}
    assert len(zero["mc"]) == 2 and zero["mc_dropped"] == 1
    tele = _np_tree(zero["hm"]["telemetry"])
    for rec in zero["mc"]:
        t = rec["round"] - 1
        _assert_tree_bitwise(rec["telemetry"],
                             _tree_index(_tree_index(tele, 0), t))
    assert one["mc"] == [] and one["mc_dropped"] == 2
