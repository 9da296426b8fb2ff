"""The port's observability (`repro_torch.obs`) against the JAX package's
(`repro.obs`): each strategy's `RoundTelemetry` on JAX's replayed draws
against JAX's ``history["telemetry"]`` field by field, the channel-use
ledger bit for bit, the fault extras and the re-clustering events, the
manifest's config hash, the JSONL sink read by JAX's ``read_run``, and the
sweep's telemetry, each element bitwise its lone run.  The protocol is
``tests/test_torch_scenarios.py``'s (K=8, hidden 32, C=3, 40 dB, 3 rounds
of 3 local steps)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import config_hash as jax_config_hash
from repro.obs import per_round_table as jax_per_round_table
from repro.obs import read_run as jax_read_run
from repro.obs import to_jsonable as jax_to_jsonable
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS
from repro.strategies import available_strategies as jax_strategies
from repro.training import FLConfig as JaxFLConfig
from repro_torch.convert import topology_from_arrays
from repro_torch.core import topology as ttopo
from repro_torch.models import small as tsmall
from repro_torch.obs import (RoundTelemetry, build_manifest, config_hash,
                             per_round_table, read_run, symbols_per_round,
                             to_jsonable, uses_per_round, write_history)
from repro_torch.sim import SCENARIOS, run_monte_carlo, run_rounds
from repro_torch.strategies import available_strategies
from repro_torch.training import FLConfig
from repro_torch.utils.nest import nest_tensors
from test_torch_scenarios import (EVAL, K, ROUNDS, JaxScenarioDraws,
                                  workload)  # noqa: F401  (a fixture)

# Telemetry on JAX's draws: f32 sums in another order than XLA's, as
# tests/test_torch_scenarios.py's channel checks.
RTOL = ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(workload, strategy="cwfl", scenario=None, rounds=ROUNDS,  # noqa: F811
          jax_draws=True, **kw):
    """The port's run on the workload (JAX's replayed draws unless
    ``jax_draws`` is false), and its pieces."""
    topo, tcfg, xs, ys, xte, yte = workload
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), ttcfg,
                                device="cpu")
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    cfg = FLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                   eval_samples=EVAL, seed=0)
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    if jax_draws:
        jinit, _ = jsmall.make_mnist_mlp(hidden=(32,))
        jcfg = JaxFLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                           eval_samples=EVAL, seed=0)
        kw["draws"] = JaxScenarioDraws(
            jinit, jcfg, xs.shape[1], xs.shape[1] // cfg.batch_size,
            JAX_SCENARIOS[scenario or "paper-static"])
    return run_rounds(init, apply, loss, ttop, *data, cfg, scenario=scenario,
                      topo_cfg=ttcfg, device="cpu", **kw)


def _jax(workload, strategy="cwfl", scenario=None, rounds=ROUNDS):  # noqa: F811
    topo, tcfg, xs, ys, xte, yte = workload
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jloss = lambda p, x, y: jsmall.nll_loss(japply(p, x), y)   # noqa: E731
    jcfg = JaxFLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                       eval_samples=EVAL, seed=0)
    return jengine.run_rounds(
        jinit, japply, jloss, topo, jnp.asarray(xs), jnp.asarray(ys), xte,
        yte, jcfg, scenario=JAX_SCENARIOS[scenario or "paper-static"],
        topo_cfg=tcfg, telemetry=True)


def assert_telemetry_matches_jax(got: RoundTelemetry, ref) -> None:
    """Field by field within RTOL/ATOL; the ledger bitwise."""
    assert sorted(got.extras) == sorted(ref.extras)
    for name in RoundTelemetry._fields:
        if name == "extras":
            continue
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if name in ("channel_uses", "cum_channel_uses", "cum_symbols",
                    "participants", "reclustered"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    for name, b in ref.extras.items():
        a, b = got.extras[name].numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


# Each strategy once, the dynamic ones where their telemetry has the most
# to show: COTAF's server failover and the fault extras under
# flaky-clients, decentralized's pruned graph (P(P−1) uses) under
# head-failure, CWFL-Prox's re-clustering events under cluster-churn (at
# this topology no head ties, so JAX's jitted election agrees).
@pytest.mark.parametrize("strategy,scenario", [
    ("cwfl", None), ("cotaf", "flaky-clients"), ("fedavg", None),
    ("decentralized", "head-failure"), ("cwfl_prox", "cluster-churn")])
def test_telemetry_matches_jax(workload, strategy, scenario):  # noqa: F811
    got = _port(workload, strategy, scenario, telemetry=True)
    ref = _jax(workload, strategy, scenario)
    tele = got["telemetry"]
    assert_telemetry_matches_jax(tele, ref["telemetry"])
    d = 784 * 32 + 32 + 32 * 10 + 10
    if scenario is None:
        # The ledger in f32, as JAX keeps it: uses × d a round.
        uses = float(uses_per_round(strategy, K, 3))
        np.testing.assert_array_equal(
            tele.cum_symbols.numpy(), np.float32(uses * d)
            * np.arange(1, ROUNDS + 1, dtype=np.float32))
    if scenario == "flaky-clients":
        for name in ("fault_alive", "fault_tx_ok", "fault_burst",
                     "fault_deep_fade", "fault_quarantined"):
            np.testing.assert_array_equal(
                tele.extras[name].numpy(),
                np.asarray(ref["telemetry"].extras[name]), err_msg=name)
        assert tele.extras["fault_alive"].min() == 0.0   # the faults struck
    if scenario == "head-failure":
        p = tele.participants.numpy()
        assert p.min() < K                      # crashed nodes pruned
        np.testing.assert_array_equal(tele.channel_uses.numpy(),
                                      p * (p - 1))
    if scenario == "cluster-churn":
        assert tele.reclustered.tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("strategy,scenario", [
    ("cwfl", None), ("cotaf", "flaky-clients"),
    ("decentralized", "head-failure"), ("fedavg", "straggler-heavy"),
    ("cwfl", "cluster-churn")])
def test_telemetry_on_is_off_bitwise_and_loop_is_scan(workload, strategy,  # noqa: F811
                                                      scenario):
    """Recording telemetry leaves every bit of the history as it is, and
    the scanned run's telemetry is the loop's, bit for bit."""
    off = _port(workload, strategy, scenario, jax_draws=False)
    on = _port(workload, strategy, scenario, jax_draws=False,
               telemetry=True)
    loop = _port(workload, strategy, scenario, jax_draws=False,
                 telemetry=True, mode="loop")
    assert "telemetry" not in off
    for key in ("train_loss", "test_acc"):
        assert torch.equal(on[key], off[key]) and torch.equal(loop[key],
                                                              off[key])
    for a, b in zip(nest_tensors(off["final_params"]),
                    nest_tensors(on["final_params"])):
        assert torch.equal(a, b)
    for k, v in off.get("scenario", {}).items():
        assert torch.equal(v, on["scenario"][k])
    assert sorted(on["telemetry"].extras) == sorted(loop["telemetry"].extras)
    for a, b in zip(nest_tensors(on["telemetry"]),
                    nest_tensors(loop["telemetry"])):
        assert torch.equal(a, b)


def test_ledger_and_per_round_table_match_jax():
    for Kc, Cc in ((12, 3), (50, 3), (50, 4), (27, 8)):
        assert per_round_table(Kc, Cc) == jax_per_round_table(Kc, Cc)
    assert per_round_table(50, 3) == {"cwfl": 9, "decentralized": 2450,
                                      "server_ota": 1}
    assert uses_per_round("fedavg", 50) == 0
    assert uses_per_round("decentralized", 50, participants=10.0) == 90.0
    assert symbols_per_round("cwfl", dim=100, num_clients=50,
                             num_clusters=3) == 900


def test_config_hash_matches_jax_for_every_scenario_and_strategy():
    assert available_strategies() == jax_strategies()
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS)
    for name, scenario in SCENARIOS.items():
        for strategy in available_strategies():
            cfg, jcfg = FLConfig(strategy=strategy), JaxFLConfig(
                strategy=strategy)
            assert to_jsonable(cfg) == jax_to_jsonable(jcfg)
            assert (config_hash(to_jsonable(cfg), to_jsonable(scenario),
                                strategy)
                    == jax_config_hash(jax_to_jsonable(jcfg),
                                       jax_to_jsonable(JAX_SCENARIOS[name]),
                                       strategy)), (name, strategy)


def test_manifest_fields_and_hash():
    cfg = FLConfig(rounds=2)
    man = build_manifest(cfg=cfg, scenario=SCENARIOS["paper-static"],
                         strategy="cwfl", extra={"note": "t"})
    for field in ("schema", "git", "torch_version", "backend", "device",
                  "device_count", "config", "config_hash", "created_unix",
                  "note"):
        assert field in man
    assert man["strategy"] == "cwfl" and man["scenario"] == "paper-static"
    json.dumps(man)
    assert man["config_hash"] == build_manifest(
        cfg=cfg, scenario=SCENARIOS["paper-static"],
        strategy="cwfl")["config_hash"]
    assert to_jsonable({"d": torch.float32, "dev": torch.device("cpu"),
                        "t": torch.arange(3)}) == {
        "d": "torch.float32", "dev": "cpu", "t": [0, 1, 2]}


def test_sink_round_trip_read_by_jax_and_reported(workload, tmp_path):  # noqa: F811
    """The port's JSONL has JAX's schema: JAX's ``read_run`` parses it, and
    ``examples/obs_report_torch.py`` renders it."""
    h = _port(workload, jax_draws=False, rounds=2, telemetry=True)
    man = build_manifest(cfg=FLConfig(rounds=2), scenario="paper-static",
                         strategy="cwfl", extra={"clients": K})
    path = tmp_path / "run.jsonl"
    assert write_history(path, h, manifest=man,
                         timings={"execute": 0.5}) == 1 + 2 + 1
    for run in (read_run(path), jax_read_run(path)):
        assert run["manifest"]["config_hash"] == man["config_hash"]
        assert [r["round"] for r in run["rounds"]] == [1, 2]
        tele = run["rounds"][0]["telemetry"]
        assert len(tele["cluster_loss"]) == 3
        assert tele["cum_channel_uses"] == 9.0
        assert tele["extras"]["precode_scale"] == h["telemetry"].extras[
            "precode_scale"][0].tolist()
        assert run["summary"]["cum_channel_uses"] == 18.0
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "obs_report_torch.py"),
         str(path)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    for section in ("# Observability report", "## Per-cluster convergence",
                    "## Communication cost", "## Phase timings"):
        assert section in out.stdout
    assert "cwfl saves" in out.stdout


@pytest.mark.parametrize("scenario", [None, "head-failure"])
def test_sweep_telemetry_is_each_lone_run(workload, scenario, tmp_path):  # noqa: F811
    """run_monte_carlo's telemetry has JAX's leading (S, G, T) axes, and
    each element is bitwise its lone telemetered run; the sink tags each
    trajectory."""
    topo, tcfg, xs, ys, xte, yte = workload
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), ttcfg,
                                device="cpu")
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    cfg = FLConfig(rounds=2, snr_db=40.0, eval_samples=EVAL, seed=0)
    grid = [20.0, 40.0]
    h = run_monte_carlo(init, apply, loss, ttop, *data, cfg,
                        scenario=scenario, topo_cfg=ttcfg, seeds=2,
                        snr_grid=grid, device="cpu", telemetry=True)
    tele = h["telemetry"]
    assert tele.cluster_loss.shape == (2, 2, 2, 3)
    assert tele.participants.shape == (2, 2, 2)
    for s in range(2):
        for g, snr in enumerate(grid):
            one = run_rounds(init, apply, loss, ttop, *data,
                             dataclasses.replace(cfg, seed=s, snr_db=snr),
                             scenario=scenario, topo_cfg=ttcfg,
                             device="cpu", telemetry=True)
            assert sorted(one["telemetry"].extras) == sorted(tele.extras)
            for a, b in zip(nest_tensors(one["telemetry"]),
                            nest_tensors(tele)):
                assert torch.equal(a, b[s, g])
    path = tmp_path / "mc.jsonl"
    write_history(path, h)
    run = jax_read_run(path)
    assert len(run["rounds"]) == 8
    assert {(r["seed"], r["snr_db"]) for r in run["rounds"]} == {
        (0, 20.0), (0, 40.0), (1, 20.0), (1, 40.0)}
    assert run["summary"]["trajectories"] == 4
