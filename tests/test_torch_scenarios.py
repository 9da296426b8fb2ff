"""The port's scenario dynamics — channel process, schedule, faults, the
engine's dynamic sync — against `repro.sim`, from the same draws.

Every random draw is rebuilt from the JAX key chain and handed to the port
as uniforms and normals (the port takes its own decisions from them): the
scenario stream is ``split(fold_in(key, _SIM_SALT), T)`` with each round's
key split 6 ways when the scenario has faults and 4 ways when it has not,
in the order (chan, csi, mask, cluster[, fault, handoff])
(`repro/sim/engine.py`); the channel's first waypoints come from
``fold_in(key, _SIM_SALT + 1)``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro.sim import processes as jproc
from repro.sim import scheduling as jsched
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS
from repro.sim.scenarios import Scenario as JaxScenario
from repro.training import FLConfig as JaxFLConfig
from repro.training import run_federated as jax_run_federated
from repro_torch.convert import params_from_jax, topology_from_arrays
from repro_torch.core import topology as ttopo
from repro_torch.models import small as tsmall
from repro_torch.sim import faults as tfaults
from repro_torch.sim import processes as tproc
from repro_torch.sim import scheduling as tsched
from repro_torch.sim.scenarios import SCENARIOS, Scenario, get_scenario
from repro_torch.training import FLConfig, run_federated
from repro_torch.utils.pytree import tree_leaves
from test_torch_slice import JaxDraws

K, C, ROUNDS, NUM_TRAIN, EVAL = 8, 3, 3, 1920, 256
# f32 transcendental and sum-order differences between XLA and ATen.
RTOL = 1e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ``jax.random.normal`` is √2·erf_inv(u) (``jax.random._normal_real``);
# the channel's draws are erf_inv(u), since XLA folds the √2 into the
# step's constants.
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_erf_inv_draw = jax.jit(
    lambda key, shape: jax.lax.erf_inv(jax.random.uniform(
        key, shape, jnp.float32, _LO, 1.0)), static_argnums=1)


def _channel_draws(key, K):
    """`repro.sim.processes.step_channel`'s draws from its key."""
    k_fade, k_shadow, k_way = jax.random.split(key, 3)
    k_re, k_im = jax.random.split(k_fade)
    return tproc.ChannelDraws(
        fade_re=_t(_erf_inv_draw(k_re, (K, K))),
        fade_im=_t(_erf_inv_draw(k_im, (K, K))),
        shadow=_t(_erf_inv_draw(k_shadow, (K, K))),
        waypoints=_t(jax.random.uniform(k_way, (K, 2))))


def _fault_draws(key, K):
    """`repro.sim.faults.step_faults`' six uniforms from its key
    (``bernoulli(k, p, shape)`` is ``uniform(k, shape) < p``)."""
    ks = jax.random.split(key, 6)
    shapes = [(K,), (K,), (), (), (K,), ()]
    return tfaults.FaultDraws(*(_t(jax.random.uniform(k, s))
                                for k, s in zip(ks, shapes)))


class JaxScenarioDraws(JaxDraws):
    """JAX's draws for one run under a dynamic scenario: the static draws
    and the scenario stream, replayed through the seam."""

    def __init__(self, init_fn, cfg, n_k, steps, scenario):
        super().__init__(init_fn, cfg, n_k, steps)
        key = jax.random.PRNGKey(cfg.seed)
        self.init_key = jax.random.fold_in(key, jengine._SIM_SALT + 1)
        ways = 4 if scenario.faults.is_trivial else 6
        self.keys = [jax.random.split(k, ways) for k in jax.random.split(
            jax.random.fold_in(key, jengine._SIM_SALT), cfg.rounds)]

    def channel_init(self, num_clients):
        return _t(jax.random.uniform(self.init_key, (num_clients, 2)))

    def channel_step(self, round_, num_clients):
        return _channel_draws(self.keys[round_][0], num_clients)

    def csi_normals(self, round_, num_clients):
        return _t(jax.random.normal(self.keys[round_][1], (num_clients,)))

    def schedule_uniforms(self, round_, num_clients):
        return _t(jax.random.uniform(self.keys[round_][2], (num_clients,)))

    def recluster_first(self, round_, num_clients):
        return torch.tensor(int(jax.random.randint(self.keys[round_][3], (),
                                                   0, num_clients)))

    def fault_uniforms(self, round_, num_clients):
        return _fault_draws(self.keys[round_][4], num_clients)


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

def test_scenario_registry_matches_jax():
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS)
    for name, ref in JAX_SCENARIOS.items():
        got = get_scenario(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), name
        assert got.is_static == ref.is_static, name
        assert got.channel.evolves_geometry == ref.channel.evolves_geometry
        assert got.channel.is_dynamic == ref.channel.is_dynamic
        assert got.schedule.is_trivial == ref.schedule.is_trivial
        assert got.faults.is_trivial == ref.faults.is_trivial
    with pytest.raises(KeyError, match="paper-static"):
        get_scenario("no-such-scenario")


# ---------------------------------------------------------------------------
# The channel process.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def channel_world():
    tcfg = jtopo.TopologyConfig(num_clients=12)
    topo = jtopo.make_topology(jax.random.PRNGKey(3), tcfg)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain),
                                ttopo.TopologyConfig(num_clients=12),
                                device="cpu")
    return tcfg, topo, ttopo.TopologyConfig(num_clients=12), ttop


def _assert_view(got, ref):
    np.testing.assert_allclose(got.link_gain.numpy(),
                               np.asarray(ref.link_gain), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.link_snr.numpy(),
                               np.asarray(ref.link_snr), rtol=RTOL)
    np.testing.assert_array_equal(got.adjacency.numpy(),
                                  np.asarray(ref.adjacency))


def test_init_channel_reproduces_the_topology(channel_world):
    tcfg, topo, ttcfg, ttop = channel_world
    key = jax.random.PRNGKey(1)
    ref = jproc.init_channel(topo, tcfg, key)
    got = tproc.init_channel(ttop, ttcfg,
                             _t(jax.random.uniform(key, (12, 2))))
    np.testing.assert_allclose(got.waypoints.numpy(),
                               np.asarray(ref.waypoints), rtol=RTOL)
    np.testing.assert_allclose(got.h_tilde.numpy(), np.asarray(ref.h_tilde),
                               rtol=RTOL, atol=1e-7)
    c = tproc._constants(tproc.ChannelProcessConfig(), ttcfg, 12)
    view = tproc.ChannelView(*tproc.channel_round(*got, None, c)[4:])
    np.testing.assert_allclose(view.link_gain.numpy(),
                               ttop.link_gain.numpy(), rtol=RTOL,
                               atol=1e-12)
    _assert_view(view, jproc.channel_view(ref, tcfg))


@pytest.mark.parametrize("name", ["mobile-fading", "cluster-churn"])
def test_step_channel_and_view_match_jax(channel_world, name):
    """Four rounds of the process from the same draws: the state and the
    round's view (gains and SNRs rel 1e-5, outage graph exact)."""
    tcfg, topo, ttcfg, ttop = channel_world
    pcfg = JAX_SCENARIOS[name].channel
    ref = jproc.init_channel(topo, tcfg, jax.random.PRNGKey(1))
    got = tproc.init_channel(ttop, ttcfg, _t(jax.random.uniform(
        jax.random.PRNGKey(1), (12, 2))))
    step = jax.jit(jproc.step_channel, static_argnums=(1, 2))
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(2), 4)):
        ref = step(ref, pcfg, tcfg, key)
        got, view = tproc.step_and_view(got, get_scenario(name).channel,
                                        ttcfg, _channel_draws(key, 12))
        for field in ("positions", "waypoints", "shadow_db"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                rtol=RTOL, atol=1e-5, err_msg=f"{field} round {t}")
        np.testing.assert_allclose(got.h_tilde.numpy(),
                                   np.asarray(ref.h_tilde), rtol=RTOL,
                                   atol=1e-6)
        _assert_view(view, jproc.channel_view(ref, tcfg))


@pytest.mark.parametrize("log_std", [0.1, 0.5])
def test_csi_perturbation_matches_jax(log_std):
    key = jax.random.PRNGKey(4)
    ref = jproc.csi_perturbation(key, 16, log_std)
    got = tproc.csi_perturbation(_t(jax.random.normal(key, (16,))), log_std)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


# ---------------------------------------------------------------------------
# The schedule and the fault plane.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    jsched.ScheduleConfig(dropout_prob=0.25, num_stragglers=3,
                          straggler_period=3),
    jsched.ScheduleConfig(dropout_prob=0.1, energy_budget=2.0),
    jsched.ScheduleConfig(num_stragglers=2, straggler_period=2,
                          energy_budget=3.0)],
    ids=["stragglers", "energy", "no-dropout"])
def test_participation_mask_matches_jax(cfg):
    """Six rounds from the same uniforms: the masks and the energy left
    are exactly JAX's."""
    Kc = 16
    tcfg = tsched.ScheduleConfig(**dataclasses.asdict(cfg))
    ref = jsched.init_schedule(cfg, Kc)
    got = tsched.init_schedule(tcfg, Kc, "cpu")
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 6)):
        ref_mask, ref = jsched.participation_mask(cfg, ref, jnp.asarray(t),
                                                  key, Kc)
        mask, got = tsched.participation_mask(
            tcfg, got, t, _t(jax.random.uniform(key, (Kc,))))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        np.testing.assert_array_equal(got.energy_left.numpy(),
                                      np.asarray(ref.energy_left))


@pytest.mark.parametrize("name", ["head-failure", "flaky-clients", "chaos"])
def test_step_faults_matches_jax(name):
    """Eight rounds of the fault chains from the same uniforms: every
    state and view field exactly JAX's."""
    Kc = 16
    cfg = (jfaults.FaultConfig(crash_prob=0.4, recover_prob=0.4,
                               burst_prob=0.5, burst_recover_prob=0.3,
                               burst_frac=0.7, deep_fade_prob=0.3,
                               deep_fade_rounds=3)
           if name == "chaos" else JAX_SCENARIOS[name].faults)
    tcfg = tfaults.FaultConfig(**dataclasses.asdict(cfg))
    ref = jfaults.init_faults(cfg, Kc)
    got = tfaults.init_faults(tcfg, Kc, "cpu")
    for key in jax.random.split(jax.random.PRNGKey(6), 8):
        ref, ref_view = jfaults.step_faults(ref, cfg, key)
        got, view = tfaults.step_faults(got, tcfg, _fault_draws(key, Kc))
        for a, b in zip(tuple(got) + tuple(view),
                        tuple(ref) + tuple(ref_view)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("limit", [0.0, 100.0])
def test_quarantine_mask_matches_jax(limit):
    """NaN, ±inf and over-power clients are flagged, the rest kept."""
    rng = np.random.default_rng(8)
    stacked = {"a": rng.standard_normal((6, 4, 3)).astype(np.float32),
               "b": rng.standard_normal((6, 5)).astype(np.float32)}
    stacked["a"][1, 2, 0] = np.nan
    stacked["b"][2, 3] = np.inf
    stacked["b"][3, 0] = -np.inf
    stacked["a"][4] *= 40.0          # ‖θ‖²/d far above 100
    ref = jfaults.quarantine_mask(jax.tree.map(jnp.asarray, stacked), limit)
    got = tfaults.quarantine_mask(params_from_jax(stacked, device="cpu"),
                                  limit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().tolist()[:4] == [1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# Trajectories: run_federated under each scenario against JAX's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workload():
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=NUM_TRAIN,
                                                 num_test=EVAL)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(1), xtr, ytr, K)
    tcfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.make_topology(jax.random.PRNGKey(7), tcfg)
    return topo, tcfg, np.asarray(xs), np.asarray(ys), xte, yte


def _run_both(workload, scenario, rounds=ROUNDS, poison=None,
              telemetry=False, strategy="cwfl", port_only=False):
    topo, tcfg, xs, ys, xte, yte = workload
    if poison is not None:
        xs = xs.copy()
        xs[poison] = np.nan
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jloss = lambda p, x, y: jsmall.nll_loss(japply(p, x), y)   # noqa: E731
    jcfg = JaxFLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                       eval_samples=EVAL, seed=0)
    jscen = JAX_SCENARIOS[scenario]
    if port_only:
        ref = None
    elif telemetry:
        ref = jengine.run_rounds(jinit, japply, jloss, topo, jnp.asarray(xs),
                                 jnp.asarray(ys), xte, yte, jcfg,
                                 scenario=jscen, topo_cfg=tcfg,
                                 telemetry=True)
    else:
        ref = jax_run_federated(jinit, japply, jloss, topo, jnp.asarray(xs),
                                jnp.asarray(ys), xte, yte, jcfg,
                                scenario=jscen, topo_cfg=tcfg)

    ttcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), ttcfg,
                                device="cpu")
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    cfg = FLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                   eval_samples=EVAL, seed=0)
    n_k = xs.shape[1]
    steps = n_k // cfg.batch_size
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    got = run_federated(init, apply, loss, ttop, *data, cfg,
                        scenario=scenario, topo_cfg=ttcfg,
                        draws=JaxScenarioDraws(jinit, jcfg, n_k, steps,
                                               jscen), device="cpu")
    return got, ref


def _assert_trajectory(got, ref):
    # Tolerances as in test_torch_slice.py: f32 sums in another order than
    # XLA's through 9 SGD steps and 3 noisy rounds.
    np.testing.assert_allclose(got["train_loss"],
                               np.asarray(ref["train_loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["test_acc"], np.asarray(ref["test_acc"]),
                               rtol=0, atol=2 / EVAL)
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree.leaves(ref["final_params"])):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


# cluster-churn re-clusters at round 0, inside JAX's jitted scan, where XLA
# sums the head distances with FMAs; the port's in-run election sums as
# XLA's jitted round does.  At this topology (seed 7) no head ties, so the
# eager and jitted elections agree; `test_cluster_churn_head_tie_matches_jax`
# runs topologies where they part.
@pytest.mark.parametrize("scenario", ["head-failure", "flaky-clients",
                                      "straggler-heavy", "mobile-fading",
                                      "cluster-churn"])
def test_run_federated_scenario_matches_jax(workload, scenario):
    got, ref = _run_both(workload, scenario)
    _assert_trajectory(got, ref)
    rec = got["scenario"]
    assert len(rec["heads"]) == ROUNDS and len(rec["heads"][0]) == C
    if scenario in ("head-failure", "flaky-clients"):
        assert min(rec["alive"]) < K     # the faults did strike


def _jax_round0_heads(topo, tcfg):
    """JAX's cluster-churn round 0 at ``cfg.seed`` = 0: its view (the
    engine's init and key chain; the jitted step and view, which are the
    engine's bits) and the heads its election picks there eagerly and
    under ``jit``."""
    from repro.core import clustering as jcl

    key = jax.random.PRNGKey(0)
    chan = jproc.init_channel(topo, tcfg,
                              jax.random.fold_in(key, jengine._SIM_SALT + 1))
    skey = jax.random.split(jax.random.fold_in(key, jengine._SIM_SALT),
                            ROUNDS)[0]
    k_chan, _, _, k_cluster = jax.random.split(skey, 4)
    pcfg = JAX_SCENARIOS["cluster-churn"].channel
    view = jax.jit(lambda s, k: jproc.channel_view(
        jproc.step_channel(s, pcfg, tcfg, k), tcfg))(chan, k_chan)
    plan = functools.partial(jcl.make_cluster_plan,
                             num_clusters=C, key=k_cluster)
    return ([int(h) for h in plan(view.link_snr, view.adjacency).heads],
            [int(h) for h in jax.jit(plan)(view.link_snr,
                                           view.adjacency).heads])


# At K = 8, the round-0 re-clusterings of topology seeds 4, 5, 8, 14, 17
# and 19 among 0..24 are ties on JAX's bits: a two-member cluster whose
# head the election's rounding picks, so the eager order elects another
# head than the jitted one.
@pytest.mark.parametrize("topology_seed", [0, 4, 9, 16, 19])
def test_cluster_churn_head_tie_matches_jax(workload, topology_seed):
    """A cluster-churn run re-clusters at round 0 on its channel view,
    which is JAX's bit for bit (`xla_math`).  Electing in JAX's jitted
    order, as JAX's engine does, the port's run follows JAX's trajectory;
    electing in the eager order, it elects the heads JAX's eager election
    picks on the same view.  At a tie (seeds 4 and 19) the two orders
    part, at 0, 9 and 16 they agree."""
    from repro_torch.core import clustering as tcl
    from repro_torch.strategies import builtin

    topo = jtopo.make_topology(jax.random.PRNGKey(topology_seed),
                               jtopo.TopologyConfig(num_clients=K))
    world = (topo,) + tuple(workload[1:])
    got, ref = _run_both(world, "cluster-churn")
    _assert_trajectory(got, ref)
    make = tcl.make_cluster_plan
    builtin.cl.make_cluster_plan = (
        lambda *a, **kw: make(*a, **dict(kw, jitted=False)))
    try:
        eager, _ = _run_both(world, "cluster-churn", rounds=1,
                             port_only=True)
    finally:
        builtin.cl.make_cluster_plan = make
    jax_eager, jax_jitted = _jax_round0_heads(topo, workload[1])
    assert got["scenario"]["heads"][0] == jax_jitted
    assert eager["scenario"]["heads"][0] == jax_eager
    assert (jax_eager != jax_jitted) == (topology_seed in (4, 19))


def test_flaky_clients_quarantines_a_poisoned_client_as_jax(workload):
    """Client 2's shard is NaN, so its update goes non-finite every round:
    both packages quarantine it alone, every round, and keep a finite
    consensus (the train loss, a mean over clients, is NaN in both)."""
    got, ref = _run_both(workload, "flaky-clients", poison=2,
                         telemetry=True)
    quarantined = np.asarray(ref["telemetry"].extras["fault_quarantined"])
    assert got["scenario"]["quarantined"] == quarantined.tolist() == [
        1.0] * ROUNDS
    assert np.all(np.isnan(got["train_loss"]))
    ref = {"train_loss": ref["train_loss"], "test_acc": ref["test_acc"],
           "final_params": ref["final_params"]}
    _assert_trajectory(got, ref)


def test_straggler_prox_runs_cwfl_with_a_warning(workload):
    """The scenario pins ``cwfl_prox``; ``cfg.strategy`` (``cwfl``) wins,
    loudly, as in JAX."""
    topo, tcfg, xs, ys, xte, yte = workload
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), ttcfg,
                                device="cpu")
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    with pytest.warns(UserWarning, match="cwfl_prox"):
        h = run_federated(init, apply, loss, ttop, *data,
                          FLConfig(rounds=2, eval_samples=EVAL),
                          scenario="straggler-prox", device="cpu")
    assert np.all(np.isfinite(h["train_loss"]))
    assert min(h["scenario"]["mask_mass"]) < K


def test_scenario_runs_are_seeded_and_static_ones_record_nothing(workload):
    """Without the seam the port draws the scenario stream itself, from
    ``cfg.seed``; ``snr-sweep`` runs as the static scenario."""
    topo, tcfg, xs, ys, xte, yte = workload
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), ttcfg,
                                device="cpu")
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    run = functools.partial(run_federated, init, apply, loss, ttop, *data,
                            FLConfig(rounds=2, eval_samples=EVAL, lr=0.05),
                            topo_cfg=ttcfg, device="cpu")
    a, b = run(scenario="flaky-clients"), run(scenario="flaky-clients")
    assert a["train_loss"] == b["train_loss"]
    assert a["scenario"] == b["scenario"]
    static, sweep = run(), run(scenario="snr-sweep")
    assert "scenario" not in static and "scenario" not in sweep
    assert static["train_loss"] == sweep["train_loss"]
    with pytest.raises(ValueError, match="TopologyConfig"):
        run_federated(init, apply, loss, ttop, *data,
                      FLConfig(rounds=1, eval_samples=EVAL),
                      scenario=Scenario(channel=tproc.ChannelProcessConfig(
                          speed=1.0)), device="cpu")
