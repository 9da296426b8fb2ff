"""The head election in each of the contexts JAX runs it in.

JAX's engine elects the offline plan eagerly, and re-clusters inside its
jitted round (`repro.sim.engine`, loop and scan alike).  Under ``jit``
XLA's CPU backend fuses the election's ``jnp.sum(diff ** 2, -1)`` into one
loop that contracts each step into an FMA (rows of at most 32 terms), and
it rewrites ``10·log10`` of the features as ``log · 4.3429451``; eagerly it
rounds each square first.  The port takes the features' dB with XLA's own
``log`` in each context (`repro_torch.core.xla_math`).  A two-member cluster puts both members at the
same distance from its centroid in exact arithmetic, so these roundings
pick its head.  The port elects in the eager order for a lone run's
offline plan, and in the jitted order for a re-clustering inside a run
and for a Monte-Carlo sweep's setup, which JAX traces
(`repro_torch.core.clustering.make_cluster_plan(jitted=True)`)."""
import dataclasses
import fractions
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro_torch.core import clustering as tcl
from repro_torch.sim.processes import ChannelView

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnums=1)
def _jax_topology_arrays(key, cfg):
    # The arrays of `tests/test_torch_offline.py`'s topology, bit for bit
    # (a jitted function's outputs steer XLA's fusion, and so the SNRs'
    # last bits).
    t = jtopo.make_topology(key, cfg)
    return t.positions, t.link_gain, t.link_snr, t.adjacency


_jax_plan = jax.jit(jcl.make_cluster_plan, static_argnums=2)
_jax_features = jax.jit(jcl.snr_features)


def _t(x):
    return torch.as_tensor(np.array(x))


def _world(K, seed):
    _, _, snr, adj = _jax_topology_arrays(
        jax.random.PRNGKey(seed), jtopo.TopologyConfig(num_clients=K))
    key = jax.random.PRNGKey(11)
    return snr, adj, key, int(jax.random.randint(key, (), 0, K))


def test_fma_f32_rounds_once():
    """`_fma_f32` against the exact a·b + c rounded once to f32 (ties to
    even), over magnitudes where an f64 sum would round twice."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4000)
         * 10.0 ** rng.integers(-3, 4, 4000)).astype(np.float32)
    c = (rng.standard_normal(4000)
         * 10.0 ** rng.integers(-6, 6, 4000)).astype(np.float32)
    got = tcl._fma_f32(torch.from_numpy(a), torch.from_numpy(a),
                       torch.from_numpy(c)).numpy()
    for x, z, g in zip(a, c, got):
        exact = fractions.Fraction(float(x)) ** 2 + fractions.Fraction(
            float(z))
        r = np.float32(float(exact))
        cands = (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf)))
        best = min(cands, key=lambda v: (
            abs(fractions.Fraction(float(v)) - exact),
            int(np.array(v).view(np.int32)) & 1))
        assert g == best, (x, z)


def test_roadmap_case_elects_as_jax_in_each_context():
    """Seed 7, K = 16, C = 3: JAX's eager plan makes client 14 the head of
    the two-member cluster {11, 14}, its jitted plan client 11.  The port
    elects 14 in the eager order on JAX's eager features, 11 in the jitted
    order on JAX's jitted features, and 11 through the strategy's in-run
    re-clustering from the link SNRs."""
    from repro_torch.strategies import get_strategy

    snr, adj, key, first = _world(16, 7)
    eager = jcl.make_cluster_plan(snr, adj, 3, key)
    jitted = _jax_plan(snr, adj, 3, key)
    assert np.asarray(eager.heads).tolist() == [12, 3, 14]
    assert np.asarray(jitted.heads).tolist() == [12, 3, 11]
    got_eager = tcl._plan_from_features(_t(jcl.snr_features(snr, adj)),
                                        _t(snr), 3, first, 50)
    got_jitted = tcl._plan_from_features(_t(_jax_features(snr, adj)),
                                         _t(snr), 3, first, 50, jitted=True)
    assert got_eager.heads.tolist() == [12, 3, 14]
    assert got_jitted.heads.tolist() == [12, 3, 11]
    own_eager = tcl.make_cluster_plan(_t(snr), _t(adj), 3, first)
    assert own_eager.heads.tolist() == [12, 3, 14]
    view = ChannelView(link_gain=None, link_snr=_t(snr), adjacency=_t(adj))
    in_run = get_strategy("cwfl").recluster(view, 3, torch.tensor(first))
    assert in_run.heads.tolist() == [12, 3, 11]
    np.testing.assert_array_equal(in_run.assignment.numpy(),
                                  np.asarray(jitted.assignment))


@pytest.mark.parametrize("K", [8, 16, 50])
def test_jitted_election_matches_jax_jit(K):
    """Ten topologies × C = 2, 3, 5: the port's jitted-order plan on JAX's
    jitted features has JAX's jitted assignment and heads, all 30 plans
    (at K = 8 and 16 the eager and jitted orders part in
    some of them; at K = 50 a row has more than 32 terms and both
    contexts sum the rounded squares in reduce-windows)."""
    parted = 0
    for seed in range(10):
        snr, adj, key, first = _world(K, seed)
        feats = _t(_jax_features(snr, adj))
        for C in (2, 3, 5):
            ref = _jax_plan(snr, adj, C, key)
            got = tcl._plan_from_features(feats, _t(snr), C, first, 50,
                                          jitted=True)
            np.testing.assert_array_equal(got.assignment.numpy(),
                                          np.asarray(ref.assignment))
            np.testing.assert_array_equal(got.heads.numpy(),
                                          np.asarray(ref.heads))
            eager = tcl._plan_from_features(feats, _t(snr), C, first, 50)
            parted += not torch.equal(eager.heads, got.heads)
    assert (parted == 0) == (K == 50), parted


@pytest.mark.parametrize("K", [8, 16])
def test_sweep_setup_elects_as_jax_sweep(K):
    """JAX's Monte-Carlo sweep traces its setup (``vmap`` under ``jit``)
    with the topology a constant of the trace: XLA folds the features at
    compile time and sums the distances to the traced centroids in the
    jitted order.  On those folded features the port's jitted order, the
    one its sweep setup (`CWFLStrategy.init_batch`) elects in, has JAX's
    sweep heads in all 30 plans, where the eager order parts from them in
    some (at K = 50 the two orders are one:
    `test_jitted_election_matches_jax_jit`)."""
    parted = 0
    for seed in range(10):
        snr, adj, key, first = _world(K, seed)
        feats = _t(jax.jit(lambda: jcl.snr_features(snr, adj))())
        for C in (2, 3, 5):
            sweep = jax.jit(jax.vmap(
                lambda k: jcl.make_cluster_plan(snr, adj, C, k).heads))
            ref = np.asarray(sweep(key[None]))[0]
            got = tcl._plan_from_features(feats, _t(snr), C, first, 50,
                                          jitted=True)
            np.testing.assert_array_equal(got.heads.numpy(), ref)
            own = tcl.make_cluster_plan(_t(snr), _t(adj), C, first,
                                        jitted=True, db_mode="folded")
            np.testing.assert_array_equal(own.heads.numpy(), ref)
            eager = tcl._plan_from_features(feats, _t(snr), C, first, 50)
            parted += not torch.equal(eager.heads, got.heads)
    assert parted > 0


@pytest.mark.parametrize("jitted", [False, True])
@pytest.mark.parametrize("K", [8, 16, 50])
def test_own_features_elect_as_jax(K, jitted):
    """Ten topologies × C = 2, 3, 5 from the link SNRs alone: the port's
    features are XLA's bits in each context (`xla_math.db10`), so its
    plan has JAX's assignment and heads in all 30, eagerly and under
    ``jit``."""
    for seed in range(10):
        snr, adj, key, first = _world(K, seed)
        for C in (2, 3, 5):
            ref = (_jax_plan(snr, adj, C, key) if jitted
                   else jcl.make_cluster_plan(snr, adj, C, key))
            got = tcl.make_cluster_plan(_t(snr), _t(adj), C, first,
                                        jitted=jitted)
            np.testing.assert_array_equal(got.assignment.numpy(),
                                          np.asarray(ref.assignment))
            np.testing.assert_array_equal(got.heads.numpy(),
                                          np.asarray(ref.heads))


def test_sweep_setup_elects_in_the_jitted_order():
    """`CWFLStrategy.init_batch` (the port's sweep setup) elects the ROADMAP
    case's heads as JAX's sweep does, from folded features in the jitted
    order; the lone run's setup (`init`) as JAX's eager plan does.  On
    JAX's link SNRs both elect 14 here; the jitted order on unfolded
    features (an in-run re-clustering) elects 11
    (`test_roadmap_case_elects_as_jax_in_each_context`)."""
    from repro_torch.convert import topology_from_arrays
    from repro_torch.core import TopologyConfig
    from repro_torch.strategies import get_strategy

    K = 16
    pos, gain, snr, adj = _jax_topology_arrays(
        jax.random.PRNGKey(7), jtopo.TopologyConfig(num_clients=K))
    _, _, key, first = _world(K, 7)
    top = dataclasses.replace(
        topology_from_arrays(np.asarray(pos), np.asarray(gain),
                             TopologyConfig(num_clients=K), device="cpu"),
        link_snr=_t(snr))

    class Draws:
        def kmeans_first(self, num_clients):
            return torch.tensor(first)

    class Cfg:
        num_clusters = 3

    strategy = get_strategy("cwfl")
    lone = strategy.init(top, Draws(), Cfg())
    batch = strategy.init_batch(top, [Draws()], Cfg(), [(0, None)])
    sweep = jax.jit(jax.vmap(
        lambda k: jcl.make_cluster_plan(snr, adj, 3, k).heads))
    eager = jcl.make_cluster_plan(snr, adj, 3, key)
    assert lone.plan.heads.tolist() == np.asarray(eager.heads).tolist() \
        == [12, 3, 14]
    assert batch.plan.heads[0].tolist() == np.asarray(
        sweep(key[None]))[0].tolist() == [12, 3, 14]


def test_jitted_sum_order_matches_xla():
    """The election's sum of squares under ``jit``, bitwise: FMA-contracted
    in index order up to 32 terms, reduce-windows of rounded squares
    above."""
    f = jax.jit(lambda a, b: jax.numpy.sum((a[:, None, :] - b[None]) ** 2,
                                           axis=-1))
    for n in (3, 8, 16, 31, 32, 33, 50, 65, 127, 200):
        rng = np.random.default_rng(n)
        a = (rng.standard_normal((n, n)) * 30).astype(np.float32)
        b = (rng.standard_normal((5, n)) * 30).astype(np.float32)
        diff = torch.from_numpy(a)[:, None, :] - torch.from_numpy(b)[None]
        np.testing.assert_array_equal(
            tcl._sum_sq_in_xla_order(diff, jitted=True).numpy(),
            np.asarray(f(a, b)), err_msg=f"n = {n}")
