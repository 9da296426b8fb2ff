"""The port's CWFL round (coefficients, flat packing, aggregate) against
`repro.core.cwfl` on identical states, params and noise.  The unit normals
are rebuilt from the JAX key with JAX's own splits (`repro/core/cwfl.py`
``_aggregate_flat``: ``k1, k2 = split(key)``, then ``_flat_leaf_noise``
per leaf with unit std)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cwfl as jcwfl
from repro.core import topology as jtopo
from repro_torch.convert import params_from_jax, plan_from_arrays
from repro_torch.core import cwfl as tcwfl
from repro_torch.utils.pytree import tree_flatten, tree_leaves

# f32 sums in another order than XLA's (the flat round, the mean-square
# power estimate): the JAX kernel itself drifts 1.9e-6 from its oracle.
ATOL = 1e-5
K, C = 8, 3


@pytest.fixture(scope="module", params=[7, 9], ids=["topo7", "topo9"])
def states(request):
    topo = jtopo.make_topology(jax.random.PRNGKey(request.param),
                               jtopo.TopologyConfig(num_clients=K))
    jstate = jcwfl.setup(topo, jcwfl.CWFLConfig(num_clusters=C, snr_db=40.0),
                         jax.random.PRNGKey(3))
    p = jstate.plan
    plan = plan_from_arrays(*(np.asarray(x) for x in (
        p.assignment, p.heads, p.membership, p.cluster_snr, p.head_mask)),
        device="cpu")
    tstate = tcwfl.CWFLState(
        plan=plan, total_power=jstate.total_power,
        **{name: torch.from_numpy(np.array(getattr(jstate, name)))
           for name in ("client_power", "head_noise_std",
                        "consensus_noise_std", "mix")})
    return jstate, tstate


def _stacked(scale, seed=0):
    """A K-stacked MLP-shaped tree; keys include fc10 so that the sorted
    leaf order (fc0, fc1, fc10, fc2) differs from the numeric one."""
    rng = np.random.default_rng(seed)
    shapes = {"fc0": (12, 8), "fc1": (8, 6), "fc2": (6, 5), "fc10": (5, 4)}
    return {name: {"w": (scale * rng.standard_normal((K,) + s)).astype(
                        np.float32),
                   "b": (scale * rng.standard_normal((K, s[1]))).astype(
                       np.float32)}
            for name, s in shapes.items()}


def _unit_noise(key, stacked):
    leaves = jax.tree.leaves(stacked)
    k1, k2 = jax.random.split(key)
    ones = jnp.ones((C,), jnp.float32)
    return tuple(torch.from_numpy(np.array(
        jcwfl._flat_leaf_noise(k, leaves, C, ones))) for k in (k1, k2))


def test_flat_pack_uses_jax_leaf_order():
    stacked = _stacked(1.0)
    leaves, treedef = tree_flatten(params_from_jax(stacked, device="cpu"))
    ref = [np.asarray(x) for x in jax.tree.leaves(stacked)]
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
    flat = tcwfl._flat_pack(leaves, K)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jcwfl._flat_pack(jax.tree.leaves(stacked),
                                                  K)))
    new, cons = tcwfl._flat_unpack(flat, flat[0], leaves, treedef, K)
    for a, b in zip(tree_leaves(new), leaves):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(cons), leaves):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("scale", [0.1, 3.0], ids=["unclipped", "clipped"])
def test_round_coefficients_match_jax(states, scale):
    jstate, tstate = states
    stacked = _stacked(scale)
    ref = jcwfl.round_coefficients(jstate, jax.tree.map(jnp.asarray, stacked))
    got = tcwfl.round_coefficients(tstate,
                                   params_from_jax(stacked, device="cpu"))
    for name, a, b in zip(("A", "eff_std1", "B", "kappa", "M"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_phase2_weights_match_jax(states):
    jstate, tstate = states
    for a, b in zip(tcwfl.phase2_weights(tstate),
                    jcwfl.phase2_weights(jstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 3.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_matches_jax(states, scale, seed):
    jstate, tstate = states
    stacked = _stacked(scale, seed)
    key = jax.random.PRNGKey(100 + seed)
    ref_new, ref_cons = jcwfl.aggregate(jax.tree.map(jnp.asarray, stacked),
                                        jstate, key)
    new, cons = tcwfl.aggregate(params_from_jax(stacked, device="cpu"),
                                tstate, _unit_noise(key, stacked))
    for a, b in zip(tree_leaves(new) + tree_leaves(cons),
                    jax.tree.leaves(ref_new) + jax.tree.leaves(ref_cons)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


LITERAL = [(False, True), (True, False), (False, False)]
LITERAL_IDS = ["unnormalized", "unprecoded", "literal"]


@pytest.mark.parametrize("normalize,precode", LITERAL, ids=LITERAL_IDS)
@pytest.mark.parametrize("scale", [0.1, 3.0], ids=["unclipped", "clipped"])
def test_round_coefficients_literal_weights_match_jax(states, scale,
                                                      normalize, precode):
    """The literal eq. (8)/(9) weights (``normalize=False``) and the
    unprecoded ones (``precode=False``): JAX's five coefficients."""
    jstate, tstate = states
    stacked = _stacked(scale)
    ref = jcwfl.round_coefficients(jstate, jax.tree.map(jnp.asarray, stacked),
                                   normalize, precode)
    got = tcwfl.round_coefficients(
        tstate, params_from_jax(stacked, device="cpu"), normalize=normalize,
        precode=precode)
    for name, a, b in zip(("A", "eff_std1", "B", "kappa", "M"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for a, b in zip(tcwfl.phase2_weights(tstate, normalize),
                    jcwfl.phase2_weights(jstate, normalize)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("normalize,precode", LITERAL, ids=LITERAL_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_literal_weights_match_jax(states, seed, normalize,
                                             precode):
    """A round in each literal-weight mode on JAX's injected noise, within
    1e-5 of JAX's (relative where the literal weights, whose rows sum
    past 1, scale the parameters up), through the same round kernel."""
    jstate, tstate = states
    stacked = _stacked(3.0, seed)
    key = jax.random.PRNGKey(200 + seed)
    ref_new, ref_cons = jcwfl.aggregate(jax.tree.map(jnp.asarray, stacked),
                                        jstate, key, normalize=normalize,
                                        precode=precode)
    new, cons = tcwfl.aggregate(params_from_jax(stacked, device="cpu"),
                                tstate, _unit_noise(key, stacked),
                                normalize=normalize, precode=precode)
    for a, b in zip(tree_leaves(new) + tree_leaves(cons),
                    jax.tree.leaves(ref_new) + jax.tree.leaves(ref_cons)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)


def test_aggregate_rejects_non_f32_leaves(states):
    _, tstate = states
    stacked = params_from_jax(_stacked(0.1), device="cpu")
    stacked["fc0"]["w"] = stacked["fc0"]["w"].to(torch.bfloat16)
    d = sum(x[0].numel() for x in tree_leaves(stacked))
    with pytest.raises(TypeError):
        tcwfl.aggregate(stacked, tstate, (torch.zeros(C, d),
                                          torch.zeros(C, d)))


@pytest.mark.parametrize("num_clients,num_clusters", [(50, 3), (16, 4)])
def test_channel_uses_match_jax(num_clients, num_clusters):
    assert tcwfl.channel_uses_per_round(num_clients, num_clusters) == (
        jcwfl.channel_uses_per_round(num_clients, num_clusters))


def test_strategy_registry_resolves_cwfl():
    from repro_torch.strategies import (CWFLStrategy, available_strategies,
                                        get_strategy, register_strategy)
    assert "cwfl" in available_strategies()
    strategy = get_strategy("cwfl")
    assert isinstance(strategy, CWFLStrategy)
    assert get_strategy(strategy) is strategy
    with pytest.raises(KeyError, match="cwfl"):
        get_strategy("no-such-strategy")
    with pytest.raises(ValueError):
        register_strategy("cwfl", CWFLStrategy(name="cwfl"))


def _fault_case(plan, case, seed=0):
    """(mask, alive) of one masked or faulty round on a K=8, C=3 plan; a
    crashed node cannot transmit, so the mask is 0 where ``alive`` is, as
    the engine folds it."""
    rng = np.random.default_rng(seed)
    heads = np.asarray(plan.heads)
    members0 = np.flatnonzero(np.asarray(plan.assignment) == 0)
    mask = (rng.uniform(size=K) < 0.6).astype(np.float32)
    alive = None
    if case == "mask-heads-off":
        mask[heads] = 0.0
    elif case == "all-masked":
        mask[:] = 0.0
    elif case == "head-crashed":
        alive = np.ones(K, np.float32)
        alive[heads[0]] = 0.0
        mask *= alive
    elif case == "dead-cluster":
        alive = np.ones(K, np.float32)
        alive[members0] = 0.0
        mask = alive.copy()
    elif case == "alive-only":
        alive = np.ones(K, np.float32)
        alive[heads[1]] = 0.0
        mask = None
    return mask, alive


FAULT_CASES = ["mask", "mask-heads-off", "all-masked", "head-crashed",
               "dead-cluster", "alive-only"]


def _both(x):
    return (None, None) if x is None else (jnp.asarray(x),
                                           torch.from_numpy(x.copy()))


def _assert_match(got, ref, name):
    """rel 1e-5, with the zeros where JAX has them."""
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(got == 0, ref == 0, err_msg=name)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("case", FAULT_CASES)
def test_participation_weights_match_jax(states, case):
    jstate, tstate = states
    (jm, tm), (ja, ta) = (_both(x) for x in _fault_case(jstate.plan, case))
    ref = jcwfl.participation_weights(jstate, jm, alive=ja)
    _assert_match(tcwfl.participation_weights(tstate, tm, alive=ta), ref,
                  "participation")
    assert tcwfl.participation_weights(tstate, None) is None


@pytest.mark.parametrize("live", [(1, 1, 1), (0, 1, 1), (1, 0, 0),
                                  (0, 0, 0)])
def test_phase2_weights_live_match_jax(states, live):
    """Dead clusters leave B̃ by column; an all-dead plan leaves zero rows
    (row sums clamped at 1e-12)."""
    jstate, tstate = states
    lv = np.array(live, bool)
    for name, a, b in zip(
            ("B", "kappa"),
            tcwfl.phase2_weights(tstate, live=torch.from_numpy(lv)),
            jcwfl.phase2_weights(jstate, live=jnp.asarray(lv))):
        _assert_match(a, b, name)


@pytest.mark.parametrize("case", FAULT_CASES)
def test_round_coefficients_masked_match_jax(states, case):
    jstate, tstate = states
    stacked = _stacked(3.0)
    mask, alive = _fault_case(jstate.plan, case)
    (jm, tm), (ja, ta) = _both(mask), _both(alive)
    ref = jcwfl.round_coefficients(jstate, jax.tree.map(jnp.asarray, stacked),
                                   mask=jm, alive=ja)
    got = tcwfl.round_coefficients(
        tstate, params_from_jax(stacked, device="cpu"), mask=tm, alive=ta)
    for name, a, b in zip(("A", "eff_std1", "B", "kappa", "M"), got, ref):
        _assert_match(a, b, name)
    if case == "dead-cluster":
        assert float(got[0][0].abs().sum()) == 0.0 and float(got[1][0]) == 0.0


@pytest.mark.parametrize("case", FAULT_CASES)
def test_aggregate_masked_match_jax(states, case):
    """The masked and faulty round, the guard on wherever ``alive`` is
    given (as `cwfl.aggregate` runs it); one client's signal is
    NaN where the round is guarded."""
    jstate, tstate = states
    stacked = _stacked(0.5, seed=3)
    mask, alive = _fault_case(jstate.plan, case, seed=1)
    guard = alive is not None
    if guard:
        stacked["fc1"]["w"][int(np.argmin(alive))] = np.nan
    (jm, tm), (ja, ta) = _both(mask), _both(alive)
    key = jax.random.PRNGKey(7)
    ref_new, ref_cons = jcwfl.aggregate(jax.tree.map(jnp.asarray, stacked),
                                        jstate, key, mask=jm, alive=ja,
                                        guard=guard)
    new, cons = tcwfl.aggregate(params_from_jax(stacked, device="cpu"),
                                tstate, _unit_noise(key, stacked), mask=tm,
                                alive=ta)
    for a, b in zip(tree_leaves(new) + tree_leaves(cons),
                    jax.tree.leaves(ref_new) + jax.tree.leaves(ref_cons)):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_deprecated_strategies_mapping_warns_and_agrees_with_jax(states):
    """`repro_torch.training.STRATEGIES`, JAX's deprecated view: every
    access warns, its names are JAX's, and the cwfl pair sets up JAX's
    plan (given JAX's first K-means pick) and aggregates as the strategy
    and as JAX's pair do on JAX's injected noise."""
    from repro.training import STRATEGIES as JAX_STRATEGIES
    from repro_torch.convert import topology_from_arrays
    from repro_torch.core import TopologyConfig
    from repro_torch.strategies import get_strategy
    from repro_torch.training import STRATEGIES

    jstate, tstate = states
    with pytest.warns(DeprecationWarning, match="repro_torch.strategies"):
        names = sorted(STRATEGIES)
    with pytest.warns(DeprecationWarning):
        assert names == sorted(JAX_STRATEGIES)
    with pytest.warns(DeprecationWarning):
        assert len(STRATEGIES) == len(names)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        setup_fn, aggregate_fn = STRATEGIES["cwfl"]
    with pytest.warns(DeprecationWarning):
        jsetup, jaggregate = JAX_STRATEGIES["cwfl"]

    topo = jtopo.make_topology(jax.random.PRNGKey(7),
                               jtopo.TopologyConfig(num_clients=K))
    ref_state = jsetup(topo, jax.random.PRNGKey(3), num_clusters=C,
                       snr_db=40.0)
    first = int(jax.random.randint(jax.random.PRNGKey(3), (), 0, K))

    class Draws:
        def kmeans_first(self, num_clients):
            return torch.tensor(first)

    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain),
                                TopologyConfig(num_clients=K), device="cpu")
    state = setup_fn(ttop, Draws(), num_clusters=C, snr_db=40.0)
    np.testing.assert_array_equal(state.plan.heads.numpy(),
                                  np.asarray(ref_state.plan.heads))

    stacked = _stacked(0.1)
    key = jax.random.PRNGKey(5)
    noise = _unit_noise(key, stacked)
    new, cons = aggregate_fn(params_from_jax(stacked, device="cpu"), tstate,
                             noise)
    again = get_strategy("cwfl").aggregate(
        params_from_jax(stacked, device="cpu"), tstate, noise)
    ref_new, ref_cons = jaggregate(jax.tree.map(jnp.asarray, stacked),
                                   jstate, key)
    for a, b, c in zip(tree_leaves(new) + tree_leaves(cons),
                       tree_leaves(again[0]) + tree_leaves(again[1]),
                       jax.tree.leaves(ref_new) + jax.tree.leaves(ref_cons)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL,
                                   rtol=0)
