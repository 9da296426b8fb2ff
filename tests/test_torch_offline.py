"""The port's offline phase (topology, channel, clustering, CWFL state)
against the JAX package, fed the JAX topology's arrays.  The JAX calls are
jitted only to compile once instead of op by op."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import clustering as jcl
from repro.core import cwfl as jcwfl
from repro.core import topology as jtopo
from repro_torch.convert import plan_from_arrays, topology_from_arrays
from repro_torch.core import channel as tch
from repro_torch.core import clustering as tcl
from repro_torch.core import cwfl as tcwfl
from repro_torch.core import topology as ttopo

# f32 transcendental (log10, pow, sqrt) and sum-order differences between
# XLA and ATen on the CPU: a few ulp, relative.
RTOL = 1e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@functools.partial(jax.jit, static_argnums=1)
def _jax_topology_arrays(key, cfg):
    t = jtopo.make_topology(key, cfg)
    return t.positions, t.link_gain, t.link_snr, t.adjacency


_jax_cluster_plan = jax.jit(jcl.make_cluster_plan, static_argnums=2)


@pytest.fixture(scope="module", params=[(16, 7), (50, 0)],
                ids=["K16", "K50"])
def world(request):
    K, seed = request.param
    cfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.Topology(
        *_jax_topology_arrays(jax.random.PRNGKey(seed), cfg),
        noise_var=cfg.noise_var, total_power=cfg.total_power)
    tcfg = ttopo.TopologyConfig(num_clients=K)
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain), tcfg,
                                device="cpu")
    return cfg, topo, tcfg, ttop


def test_pathloss_and_link_stats_match_jax(world):
    cfg, topo, tcfg, ttop = world
    np.testing.assert_allclose(
        ttopo.pathloss_amplitude(ttop.positions, tcfg).numpy(),
        np.asarray(jtopo.pathloss_amplitude(topo.positions, cfg)), rtol=RTOL)
    np.testing.assert_allclose(ttop.link_snr.numpy(),
                               np.asarray(topo.link_snr), rtol=RTOL)
    np.testing.assert_array_equal(ttop.adjacency.numpy(),
                                  np.asarray(topo.adjacency))


@pytest.mark.parametrize("total_power", [1e4, 3.0])
def test_water_filling_matches_jax(total_power):
    gains = np.random.default_rng(3).lognormal(0.0, 2.0, 24).astype(
        np.float32)
    gains[5] = 0.0          # clamped at 1e-12: no water for this client
    p = tch.water_filling(_t(gains), total_power).numpy()
    ref = np.asarray(jch.water_filling(jnp.asarray(gains), total_power))
    np.testing.assert_allclose(p, ref, rtol=RTOL, atol=1e-6 * total_power)
    np.testing.assert_allclose(p.sum(), total_power, rtol=RTOL)


def test_precoding_and_noise_budget_match_jax():
    rng = np.random.default_rng(4)
    p_k = rng.uniform(0.1, 10.0, 12).astype(np.float32)
    msq = rng.uniform(0.0, 5.0, 12).astype(np.float32)
    np.testing.assert_allclose(
        tch.precode_amplitude(_t(p_k), _t(msq)).numpy(),
        np.asarray(jch.precode_amplitude(jnp.asarray(p_k), jnp.asarray(msq))),
        rtol=RTOL)
    assert tch.snr_db_to_noise_var(1e4, 40.0) == jch.snr_db_to_noise_var(
        1e4, 40.0)


@pytest.mark.parametrize("num_clusters", [2, 3, 5])
def test_cluster_plan_matches_jax(world, num_clusters):
    """Given JAX's first K-means pick, the plan is the same plan.  JAX's
    plan is jitted, so the port's is taken in the jitted context: the
    features' dB and the election's sums as XLA's jit takes them (at K =
    16, C = 3 the eager context elects another head, as JAX's eager plan
    does: `tests/test_torch_election.py`)."""
    cfg, topo, tcfg, ttop = world
    K = cfg.num_clients
    key = jax.random.PRNGKey(11)
    first = int(jax.random.randint(key, (), 0, K))
    ref = _jax_cluster_plan(topo.link_snr, topo.adjacency, num_clusters, key)
    plan = tcl.make_cluster_plan(ttop.link_snr, ttop.adjacency, num_clusters,
                                 first, jitted=True)
    np.testing.assert_array_equal(plan.assignment.numpy(),
                                  np.asarray(ref.assignment))
    np.testing.assert_array_equal(plan.heads.numpy(), np.asarray(ref.heads))
    np.testing.assert_array_equal(plan.membership.numpy(),
                                  np.asarray(ref.membership))
    np.testing.assert_array_equal(plan.head_mask.numpy(),
                                  np.asarray(ref.head_mask))
    np.testing.assert_allclose(plan.cluster_snr.numpy(),
                               np.asarray(ref.cluster_snr), rtol=RTOL)


@pytest.mark.parametrize("seed,num_clusters,members,jax_head", [
    (4, 5, (0, 13), 0), (7, 3, (11, 14), 14)],
    ids=["jax-lower", "jax-higher"])
def test_two_member_cluster_elects_its_lower_index(seed, num_clusters,
                                                   members, jax_head):
    """A two-member cluster's members tie for head in exact arithmetic, so
    the f32 rounding of the sum of squares picks the head: the lower index
    at the first case, the higher at the second.  Fed JAX's features, the
    port sums in XLA's order and elects JAX's head at both; the rest of
    the plan agrees.  JAX runs eagerly here, as the engine's setup runs
    it: under ``jit`` XLA contracts the sum into FMAs and elects the other
    member at both cases."""
    K = 16
    cfg = jtopo.TopologyConfig(num_clients=K)
    pos, gain, snr, adj = _jax_topology_arrays(jax.random.PRNGKey(seed), cfg)
    key = jax.random.PRNGKey(11)
    ref = jcl.make_cluster_plan(snr, adj, num_clusters, key)
    feats = _t(jcl.snr_features(snr, adj))
    first = int(jax.random.randint(key, (), 0, K))
    plan = tcl._plan_from_features(feats, _t(snr), num_clusters, first, 50)
    np.testing.assert_array_equal(plan.assignment.numpy(),
                                  np.asarray(ref.assignment))
    c = int(np.asarray(ref.assignment)[members[0]])
    assert tuple(np.flatnonzero(np.asarray(ref.assignment) == c)) == members
    assert int(np.asarray(ref.heads)[c]) == jax_head
    np.testing.assert_array_equal(plan.heads.numpy(), np.asarray(ref.heads))


@pytest.mark.parametrize("n", [5, 16, 32, 33, 50, 63, 64, 65, 80, 95, 96,
                               100, 127, 128, 160, 200, 1025, 5000])
def test_sum_in_xla_order_matches_xla(n):
    """The head election's sum of squares, bitwise against XLA's eager CPU
    reduction, at row lengths (the client count K) in index order (n <=
    32), in reduce-window blocks of 32 with the padding split front and
    back (65, 80, 100, 200), with none (64, 96, 128, 160) or one term of
    it (127), and two levels of blocks (1025, 5000).  The rows are the
    election's own form, squared differences of features and centroids."""
    rng = np.random.default_rng(n)
    feats = (rng.standard_normal((50, 1, n)) * 30).astype(np.float32)
    cents = (rng.standard_normal((1, 5, n)) * 30).astype(np.float32)
    ref = jnp.sum((jnp.asarray(feats) - jnp.asarray(cents)) ** 2, axis=-1)
    diff = torch.from_numpy(feats) - torch.from_numpy(cents)
    np.testing.assert_array_equal(tcl._sum_in_xla_order(diff * diff).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("K,num_clusters,seed", [(65, 5, 26), (65, 5, 57),
                                                 (127, 5, 5)])
def test_head_election_above_64_clients_matches_jax(K, num_clusters, seed):
    """Above 64 clients XLA sums each distance in reduce-window blocks;
    fed JAX's features, the port elects JAX's eager heads.  Each case has
    a two-member cluster, whose head the f32 rounding of that sum picks:
    three of the four such plans in a sweep of 1,050 at K = 65, 80, 100,
    127, 200, C = 2, 3, 5, topology seeds 0..69, all of which agree."""
    cfg = jtopo.TopologyConfig(num_clients=K)
    _, _, snr, adj = _jax_topology_arrays(jax.random.PRNGKey(seed), cfg)
    key = jax.random.PRNGKey(11)
    ref = jcl.make_cluster_plan(snr, adj, num_clusters, key)
    sizes = np.bincount(np.asarray(ref.assignment), minlength=num_clusters)
    assert 2 in sizes
    first = int(jax.random.randint(key, (), 0, K))
    plan = tcl._plan_from_features(_t(jcl.snr_features(snr, adj)), _t(snr),
                                   num_clusters, first, 50)
    np.testing.assert_array_equal(plan.assignment.numpy(),
                                  np.asarray(ref.assignment))
    np.testing.assert_array_equal(plan.heads.numpy(), np.asarray(ref.heads))


@pytest.mark.parametrize("case", ["random0", "random1", "random2",
                                  "heads-dead", "dead-cluster", "all-dead",
                                  "all-up"])
def test_reelect_heads_matches_jax(world, case):
    """Dead heads are replaced by the best surviving member; a fully dead
    cluster keeps its head.  Both sides take JAX's link SNRs."""
    cfg, topo, tcfg, ttop = world
    K = cfg.num_clients
    ref_plan = _jax_cluster_plan(topo.link_snr, topo.adjacency, 3,
                                 jax.random.PRNGKey(5))
    heads = np.asarray(ref_plan.heads)
    assign = np.asarray(ref_plan.assignment)
    alive = np.ones(K, np.float32)
    if case.startswith("random"):
        rng = np.random.default_rng(int(case[-1]))
        alive = (rng.uniform(size=K) < 0.6).astype(np.float32)
        alive[heads[int(case[-1])]] = 0.0
    elif case == "heads-dead":
        alive[heads] = 0.0
    elif case == "dead-cluster":
        alive[assign == assign[heads[1]]] = 0.0
        alive[heads[0]] = 0.0
    elif case == "all-dead":
        alive[:] = 0.0
    ref = jcl.reelect_heads(ref_plan, topo.link_snr, jnp.asarray(alive))
    plan = plan_from_arrays(*(np.asarray(x) for x in (
        ref_plan.assignment, ref_plan.heads, ref_plan.membership,
        ref_plan.cluster_snr, ref_plan.head_mask)), device="cpu")
    got = tcl.reelect_heads(plan, _t(topo.link_snr), _t(alive))
    np.testing.assert_array_equal(got.heads.numpy(), np.asarray(ref.heads))
    np.testing.assert_array_equal(got.head_mask.numpy(),
                                  np.asarray(ref.head_mask))
    np.testing.assert_array_equal(got.membership.numpy(),
                                  np.asarray(ref.membership))
    np.testing.assert_allclose(got.cluster_snr.numpy(),
                               np.asarray(ref.cluster_snr), rtol=RTOL)
    if case == "heads-dead":
        assert not np.any(np.isin(got.heads.numpy(), heads))


def test_consensus_weights_match_jax():
    xi = np.array([3.0, 0.5, 120.0, 7.0], np.float32)
    np.testing.assert_allclose(
        tcl.consensus_weights(_t(xi)).numpy(),
        np.asarray(jcl.consensus_weights(jnp.asarray(xi))), rtol=RTOL)


def test_state_from_plan_matches_jax(world):
    cfg, topo, tcfg, ttop = world
    ref_plan = _jax_cluster_plan(topo.link_snr, topo.adjacency, 3,
                                 jax.random.PRNGKey(5))
    noise_var = jch.snr_db_to_noise_var(cfg.total_power, 40.0)
    ref = jcwfl.state_from_plan(ref_plan, topo.link_gain,
                                float(topo.total_power), noise_var)
    plan = plan_from_arrays(*(np.asarray(x) for x in (
        ref_plan.assignment, ref_plan.heads, ref_plan.membership,
        ref_plan.cluster_snr, ref_plan.head_mask)), device="cpu")
    state = tcwfl.state_from_plan(plan, ttop.link_gain,
                                  float(ttop.total_power), noise_var)
    assert state.total_power == ref.total_power
    for name in ("client_power", "head_noise_std", "consensus_noise_std",
                 "mix"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=RTOL,
                                   err_msg=name)


def test_setup_matches_jax_given_the_first_pick(world):
    cfg, topo, tcfg, ttop = world
    key = jax.random.PRNGKey(2)
    ref = jcwfl.setup(topo, jcwfl.CWFLConfig(num_clusters=3, snr_db=40.0),
                      key)
    first = int(jax.random.randint(key, (), 0, cfg.num_clients))
    state = tcwfl.setup(ttop, tcwfl.CWFLConfig(num_clusters=3, snr_db=40.0),
                        first)
    np.testing.assert_array_equal(state.plan.heads.numpy(),
                                  np.asarray(ref.plan.heads))
    np.testing.assert_allclose(state.client_power.numpy(),
                               np.asarray(ref.client_power), rtol=RTOL)


def test_make_topology_is_reciprocal_and_seeded():
    """The port draws its own topology (Philox, not threefry): check the
    structure JAX's has — conjugate-symmetric complex64 gains with a zero
    diagonal, a symmetric outage graph — and seed determinism."""
    cfg = ttopo.TopologyConfig(num_clients=12)
    a = ttopo.make_topology(3, cfg, device="cpu")
    b = ttopo.make_topology(3, cfg, device="cpu")
    assert a.link_gain.dtype == torch.complex64
    assert a.positions.shape == (12, 2)
    torch.testing.assert_close(a.link_gain, a.link_gain.T.conj())
    assert torch.all(torch.diagonal(a.link_gain) == 0)
    assert torch.equal(a.adjacency, a.adjacency.T)
    assert torch.equal(a.link_gain, b.link_gain)
    assert not torch.equal(
        a.link_gain, ttopo.make_topology(4, cfg, device="cpu").link_gain)
