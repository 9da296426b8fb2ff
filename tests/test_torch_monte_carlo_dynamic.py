"""The batched Monte-Carlo sweep under dynamic scenarios on the CPU, and
the client-sharded round in scan mode.

``run_monte_carlo`` under each dynamic scenario against JAX's vmapped
sweep on JAX's draws (the scenario stream included), seed by seed; each
batched element, its records included, bit for bit the port's lone
``run_rounds``; ``shard="mc"`` over two gloo processes under a dynamic
scenario against the unsharded sweep; ``run_rounds(shard="clients")``
scanned over two gloo processes against its loop.  K = 8, the MLP with
one hidden layer of 32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS
from repro.training import FLConfig as JaxFLConfig
from repro_torch.convert import topology_from_arrays
from repro_torch.core import TopologyConfig
from repro_torch.models import small as tsmall
from repro_torch.sim import run_monte_carlo, run_rounds
from repro_torch.training import FLConfig
from repro_torch.utils.pytree import tree_leaves
from test_torch_dist import _spawn
from test_torch_scenarios import JaxScenarioDraws

K, NUM_TRAIN, EVAL = 8, 1920, 256


@pytest.fixture(scope="module")
def workload():
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=NUM_TRAIN,
                                                 num_test=EVAL)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(1), xtr, ytr, K)
    topo = jtopo.make_topology(jax.random.PRNGKey(7),
                               jtopo.TopologyConfig(num_clients=K))
    return topo, tuple(np.array(a) for a in (xs, ys, xte, yte))


def _port(workload):
    topo, data = workload
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain),
                                TopologyConfig(num_clients=K), device="cpu")
    return (init, apply, lambda p, x, y: tsmall.nll_loss(apply(p, x), y),
            ttop, *(torch.from_numpy(a) for a in data))


# (strategy, scenario, SNR grid): each dynamic scenario with its pinned
# or default strategy, COTAF's server failover under head-failure,
# decentralized mixing under mobile-fading, and a fault scenario over an
# SNR grid.
JAX_CASES = [
    ("cwfl", "head-failure", None), ("cwfl", "flaky-clients", None),
    ("cwfl", "straggler-heavy", None), ("cwfl_prox", "straggler-prox", None),
    ("cwfl", "mobile-fading", None), ("cwfl", "cluster-churn", None),
    ("cotaf", "head-failure", None), ("decentralized", "mobile-fading", None),
    ("cwfl", "flaky-clients", (10.0, 30.0)),
]


@pytest.mark.parametrize("strategy,scenario,grid", JAX_CASES,
                         ids=[f"{s}-{n}" + ("-grid" if g else "")
                              for s, n, g in JAX_CASES])
def test_dynamic_sweep_matches_jax(workload, strategy, scenario, grid):
    """2 seeds (x the grid), 3 rounds (the stragglers miss round 2,
    cluster-churn re-clusters at round 0), JAX's draws replayed seed by
    seed: every element against JAX's vmapped sweep, loss within 1e-5
    relative and accuracy within 2/eval_samples."""
    topo, data = workload
    rounds, seeds = 3, 2
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jcfg = JaxFLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                       eval_samples=EVAL, seed=0)
    jscen = JAX_SCENARIOS[scenario]
    ref = jengine.run_monte_carlo(
        jinit, japply, lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
        topo, *(jnp.asarray(a) for a in data), jcfg, scenario=jscen,
        topo_cfg=jtopo.TopologyConfig(num_clients=K), seeds=seeds,
        snr_grid=grid)
    n_k = data[0].shape[1]
    steps = n_k // jcfg.batch_size
    draws = [JaxScenarioDraws(jinit, dataclasses.replace(jcfg, seed=s), n_k,
                              steps, jscen) for s in range(seeds)]
    cfg = FLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                   eval_samples=EVAL, seed=0)
    got = run_monte_carlo(*_port(workload), cfg, scenario=scenario,
                          topo_cfg=TopologyConfig(num_clients=K),
                          seeds=seeds, snr_grid=grid, draws=draws,
                          device="cpu")
    lead = (seeds,) if grid is None else (seeds, len(grid))
    assert got["train_loss"].shape == lead + (rounds,)
    assert got["scenario"]["alive"].shape == lead + (rounds,)
    np.testing.assert_allclose(got["train_loss"].numpy(),
                               np.asarray(ref["train_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"].numpy(),
                               np.asarray(ref["test_acc"]), atol=2 / EVAL)


# (strategy, scenario): the six strategies, each under the scenarios that
# reach its hooks (failover, masks, re-election, re-clustering, graphs).
LONE_CASES = [
    ("cwfl", "head-failure"), ("cwfl", "flaky-clients"),
    ("cwfl", "straggler-heavy"), ("cwfl", "mobile-fading"),
    ("cwfl", "cluster-churn"), ("cwfl_prox", "straggler-prox"),
    ("cotaf", "head-failure"), ("cotaf_prox", "flaky-clients"),
    ("fedavg", "flaky-clients"), ("fedavg", "mobile-fading"),
    ("decentralized", "straggler-heavy"), ("decentralized", "mobile-fading"),
]


@pytest.mark.parametrize("strategy,scenario", LONE_CASES,
                         ids=[f"{s}-{n}" for s, n in LONE_CASES])
def test_dynamic_sweep_elements_equal_lone_runs(workload, strategy,
                                                scenario):
    """Each trajectory of a 3-seed x 2-SNR sweep of 6 rounds (the
    stragglers miss rounds 2 and 5, cluster-churn re-clusters at rounds 0
    and 5), bit for bit the port's lone ``run_rounds`` with the same seed
    and SNR: losses, accuracies and the scenario records (live nodes,
    mask mass, quarantined clients, heads)."""
    port = _port(workload)
    topo_cfg = TopologyConfig(num_clients=K)
    cfg = FLConfig(strategy=strategy, rounds=6, snr_db=40.0,
                   eval_samples=EVAL, seed=5, lr=0.05)
    grid = [0.0, 20.0]
    h = run_monte_carlo(*port, cfg, scenario=scenario, topo_cfg=topo_cfg,
                        seeds=3, snr_grid=grid, device="cpu")
    for s in range(3):
        for g, snr in enumerate(grid):
            one = run_rounds(*port, dataclasses.replace(
                cfg, seed=cfg.seed + s, snr_db=snr), scenario=scenario,
                topo_cfg=topo_cfg, device="cpu")
            assert torch.equal(h["train_loss"][s, g], one["train_loss"])
            assert torch.equal(h["test_acc"][s, g], one["test_acc"])
            assert h["scenario"].keys() == one["scenario"].keys()
            for k, v in one["scenario"].items():
                assert torch.equal(h["scenario"][k][s, g], v), k


def test_dynamic_sweep_starts_from_jax_sweeps_channel_state(workload,
                                                            monkeypatch):
    """At JAX's topology seed 7 the eager and the jitted pathloss part in
    the last bit at two links.  JAX's lone run takes its first channel
    state eagerly and its sweep under ``jit``; the port's lone run and
    sweep start from the same states as JAX's, bit for bit, so here a
    sweep element's channel state is not its lone run's."""
    from repro.sim import processes as jproc
    from repro_torch.sim import engine

    topo, _ = workload
    jcfg = jtopo.TopologyConfig(num_clients=K)
    key = jax.random.PRNGKey(0)
    want = {"eager": np.asarray(jproc.init_channel(topo, jcfg, key).h_tilde),
            "jit": np.asarray(jax.jit(lambda k: jproc.init_channel(
                topo, jcfg, k).h_tilde)(key))}
    assert not np.array_equal(want["eager"], want["jit"])
    step, firsts = engine.step_and_view, []

    def recording(state, *args):
        firsts.append(state.h_tilde.clone())
        return step(state, *args)

    monkeypatch.setattr(engine, "step_and_view", recording)
    cfg = FLConfig(rounds=1, snr_db=40.0, eval_samples=EVAL, seed=0,
                   lr=0.05)
    kw = dict(scenario="cluster-churn", topo_cfg=TopologyConfig(
        num_clients=K), device="cpu")
    run_monte_carlo(*_port(workload), cfg, seeds=2, **kw)
    run_rounds(*_port(workload), cfg, **kw)
    sweep, lone = firsts
    for b in range(2):
        np.testing.assert_array_equal(sweep[b].numpy(), want["jit"])
    np.testing.assert_array_equal(lone.numpy(), want["eager"])


def test_dynamic_sweep_hands_the_kernel_a_dead_row(workload, monkeypatch):
    """A fault sweep whose clusters die (crash 0.6, recover 0.2) hands the
    batched round kernel (guarded) a dead Ã row in one trajectory while
    another trajectory's rows are live, and each element still equals
    its lone run."""
    from repro_torch.core import cwfl
    from repro_torch.sim import FaultConfig, Scenario

    launch, seen = cwfl.cwfl_round, []

    def counting(signals, phase1, *args, **kwargs):
        if phase1.ndim == 3:
            seen.append((phase1.abs().sum(dim=-1) <= 0).sum(dim=-1))
        return launch(signals, phase1, *args, **kwargs)

    monkeypatch.setattr(cwfl, "cwfl_round", counting)
    scenario = Scenario(name="dead-cluster",
                        faults=FaultConfig(crash_prob=0.6, recover_prob=0.2))
    port = _port(workload)
    cfg = FLConfig(rounds=4, snr_db=40.0, eval_samples=EVAL, seed=0,
                   lr=0.05)
    h = run_monte_carlo(*port, cfg, scenario=scenario, seeds=4,
                        device="cpu")
    dead = torch.stack(seen)                                  # (rounds, B)
    assert dead.shape == (4, 4)
    assert bool(((dead > 0).any(dim=1) & (dead == 0).any(dim=1)).any())
    monkeypatch.setattr(cwfl, "cwfl_round", launch)
    for s in range(4):
        one = run_rounds(*port, dataclasses.replace(cfg, seed=s),
                         scenario=scenario, device="cpu")
        assert torch.equal(h["train_loss"][s], one["train_loss"])
        assert torch.equal(h["scenario"]["alive"][s],
                           one["scenario"]["alive"])


def _mc_job(rank, world, p):
    """This rank's part of the 3-seed x 3-SNR flaky-clients sweep."""
    port = _port(p["workload"])
    h = run_monte_carlo(*port, p["cfg"], scenario="flaky-clients", seeds=3,
                        snr_grid=p["grid"], shard="mc", device="cpu")
    out = {k: h[k].numpy() for k in ("train_loss", "test_acc", "final_acc")}
    out.update({f"scenario/{k}": v.numpy()
                for k, v in h["scenario"].items()})
    return out


def test_dynamic_shard_mc_over_two_ranks_equals_unsharded(workload,
                                                          tmp_path):
    cfg = FLConfig(rounds=3, snr_db=40.0, eval_samples=EVAL, seed=2,
                   lr=0.05)
    grid = [0.0, 15.0, 30.0]
    ref = run_monte_carlo(*_port(workload), cfg, scenario="flaky-clients",
                          seeds=3, snr_grid=grid, device="cpu")
    ranks = _spawn(_mc_job, 2, {"workload": workload, "cfg": cfg,
                                "grid": grid}, tmp_path)
    want = {k: ref[k].numpy() for k in ("train_loss", "test_acc",
                                        "final_acc")}
    want.update({f"scenario/{k}": v.numpy()
                 for k, v in ref["scenario"].items()})
    for got in ranks:
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _sharded_scan_job(rank, world, p):
    """``run_rounds(shard="clients")`` on this rank, scanned and looped."""
    port = _port(p["workload"])
    out = {}
    for mode in ("scan", "loop"):
        h = run_rounds(*port, p["cfg"], device="cpu", shard="clients",
                       mode=mode)
        out[mode] = [h["train_loss"].numpy(), h["test_acc"].numpy(),
                     *(x.numpy() for x in tree_leaves(h["final_params"]))]
    return out


@pytest.mark.parametrize("strategy", ["cwfl", "cwfl_prox"])
def test_client_sharded_scan_equals_loop_over_two_ranks(workload, tmp_path,
                                                        strategy):
    """Two gloo ranks of four clients each: the default scanned mode's
    history (losses, accuracies, final params) bit for bit the loop's,
    the same on both ranks."""
    cfg = FLConfig(strategy=strategy, rounds=3, snr_db=40.0,
                   eval_samples=EVAL, seed=0, lr=0.05)
    ranks = _spawn(_sharded_scan_job, 2, {"workload": workload, "cfg": cfg},
                   tmp_path)
    for got in ranks:
        for a, b, c in zip(got["scan"], got["loop"], ranks[0]["scan"],
                           strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
