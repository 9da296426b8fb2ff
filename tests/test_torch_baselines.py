"""The port's baselines — `repro_torch.core.baselines`, `channel.ota_mac`
and the strategy registry with its flags and hooks — against
`repro.core.baselines`, `repro.core.channel` and `repro.strategies`, on
the same numpy inputs.

Each baseline's sync noise is JAX's own: `_mix_rows` splits the
aggregation key into one key a leaf and draws ``normal(key, (rows,
size))`` for each, which is ``_flat_leaf_noise(key, leaves, rows, 1)``
as one (rows, d) matrix of unit normals, handed to the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import channel as jch
from repro.core import cwfl as jcwfl
from repro.core import topology as jtopo
from repro.strategies import available_strategies as jax_available
from repro.strategies import get_strategy as jax_get_strategy
from repro_torch.convert import (cotaf_state_from_arrays,
                                 decentralized_state_from_arrays,
                                 params_from_jax, topology_from_arrays)
from repro_torch.core import baselines as tb
from repro_torch.core import channel as tch
from repro_torch.core import topology as ttopo
from repro_torch.core.cwfl import CWFLState
from repro_torch.sim.processes import ChannelView
from repro_torch.strategies import (PAPER_MU_PROX, COTAFStrategy,
                                    DecentralizedStrategy, FedAvgStrategy,
                                    available_strategies, get_strategy)
from repro_torch.utils.pytree import tree_leaves

K = 8
# f32 sums in another order than XLA's (the flat product against JAX's
# per-leaf one) and the transcendental differences of water-filling.
ATOL = 1e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _stacked(seed, k=K):
    """A K-stacked tree of three leaves (d = 15 + 3 + 7 = 25 a client),
    numpy, as JAX and the port both take it."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((k, 5, 3)).astype(np.float32),
                  "b": rng.standard_normal((k, 3)).astype(np.float32)},
            "c": (3.0 * rng.standard_normal((k, 7))).astype(np.float32)}


def _unit(key, tree, rows):
    """JAX's `_mix_rows` noise from ``key`` as (rows, d) unit normals."""
    leaves = jax.tree.leaves(tree)
    return _t(jcwfl._flat_leaf_noise(key, leaves, rows,
                                     jnp.ones((rows,), jnp.float32)))


def _assert_trees(got, ref, atol=ATOL, equal_nan=False):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, equal_nan=equal_nan)


@pytest.fixture(scope="module")
def topo():
    cfg = jtopo.TopologyConfig(num_clients=K)
    jt = jtopo.make_topology(jax.random.PRNGKey(7), cfg)
    tt = topology_from_arrays(np.asarray(jt.positions),
                              np.asarray(jt.link_gain),
                              ttopo.TopologyConfig(num_clients=K),
                              device="cpu")
    return jt, tt


# ---------------------------------------------------------------------------
# channel.ota_mac
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise_std", [0.0, 0.3])
def test_ota_mac_matches_jax(noise_std):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((K, 33)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, K).astype(np.float32)
    m = (rng.uniform(size=K) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = jch.ota_mac(jnp.asarray(s), jnp.asarray(a), jnp.asarray(m), key,
                      noise_std)
    got = tch.ota_mac(_t(s), _t(a), _t(m),
                      _t(jax.random.normal(key, (33,))), noise_std)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# Metropolis weights and the decentralized state
# ---------------------------------------------------------------------------

def _random_graph(rng, k, p):
    upper = np.triu(rng.uniform(size=(k, k)) < p, 1)
    return upper | upper.T


@pytest.mark.parametrize("case", ["dense", "sparse", "outage-pruned"])
def test_metropolis_weights_match_jax(topo, case):
    """Random graphs, and the topology's outage graph with a round's mask
    pruned out of it (isolated nodes: W(k,k) = 1)."""
    rng = np.random.default_rng(3)
    if case == "outage-pruned":
        mask = rng.uniform(size=K) < 0.5
        adj = np.asarray(topo[0].adjacency) & mask[:, None] & mask[None, :]
    else:
        adj = _random_graph(rng, 12, 0.7 if case == "dense" else 0.15)
    assert case == "dense" or np.any(adj.sum(axis=1) == 0)
    ref = jb.metropolis_weights(jnp.asarray(adj))
    got = tb.metropolis_weights(_t(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


def test_decentralized_setup_matches_jax(topo):
    jt, tt = topo
    ref = jb.decentralized_setup(jt, jax.random.PRNGKey(0), snr_db=40.0)
    got = tb.decentralized_setup(tt, snr_db=40.0)
    np.testing.assert_allclose(got.mixing.numpy(), np.asarray(ref.mixing),
                               atol=1e-7)
    np.testing.assert_allclose(float(got.noise_std), float(ref.noise_std),
                               rtol=1e-6)
    assert got.total_power == ref.total_power


# ---------------------------------------------------------------------------
# COTAF's state and its server
# ---------------------------------------------------------------------------

def test_cotaf_server_agrees_with_jax_over_many_topologies():
    """The server is the argmax of the mean |h|² of a link-gain row, where
    f32 rounding could break a near-tie otherwise than XLA does.  Over 200
    topologies of ``make_topology`` (K = 8 and 16: 70 seeds each; K = 50:
    60) the port picks JAX's server in 200 of 200, and water-fills within
    1e-6 of JAX's powers."""
    agree, total, worst = 0, 0, 0.0
    for k, seeds in ((8, 70), (16, 70), (50, 60)):
        cfg = jtopo.TopologyConfig(num_clients=k)
        keys = jax.random.split(jax.random.PRNGKey(k), seeds)
        gains = np.asarray(jax.jit(jax.vmap(
            lambda key: jtopo.make_topology(key, cfg).link_gain))(keys))
        ref = jax.jit(jax.vmap(lambda g: jb.cotaf_state_from_gains(
            g, cfg.total_power, cfg.noise_var)))(jnp.asarray(gains))
        for i in range(seeds):
            got = tb.cotaf_state_from_gains(_t(gains[i]), cfg.total_power,
                                            cfg.noise_var)
            total += 1
            if int(got.server) == int(ref.server[i]):
                agree += 1
                worst = max(worst, float(np.max(np.abs(
                    got.client_power.numpy()
                    - np.asarray(ref.client_power[i])))))
    assert total == 200
    assert agree == 200, f"server agreement {agree}/{total}"
    assert worst <= 1e-6 * cfg.total_power


@pytest.mark.parametrize("case", ["plain", "alive", "all-dead", "csi",
                                  "pinned"])
def test_cotaf_state_from_gains_matches_jax(topo, case):
    """Failover over ``alive`` (the best-connected server crashed; every
    node down keeps the unmasked pick), imperfect CSI, a pinned server."""
    jt, _ = topo
    gains = np.asarray(jt.link_gain)
    best = int(np.argmax(np.mean(np.abs(gains) ** 2, axis=1)))
    kw_j, kw_t = {}, {}
    if case in ("alive", "all-dead"):
        alive = np.ones(K, np.float32)
        alive[best if case == "alive" else slice(None)] = 0.0
        kw_j["alive"], kw_t["alive"] = jnp.asarray(alive), _t(alive)
    elif case == "csi":
        csi = np.exp(0.3 * np.random.default_rng(4).standard_normal(K))
        kw_j["csi_perturb"] = jnp.asarray(csi, jnp.float32)
        kw_t["csi_perturb"] = _t(csi, torch.float32)
    elif case == "pinned":
        kw_j["server"] = kw_t["server"] = 3
    ref = jb.cotaf_state_from_gains(jnp.asarray(gains), jt.total_power,
                                    1e-3, **kw_j)
    got = tb.cotaf_state_from_gains(_t(gains), jt.total_power, 1e-3,
                                    **kw_t)
    assert int(got.server) == int(ref.server)
    assert (int(got.server) != best) == (case in ("alive", "pinned"))
    np.testing.assert_allclose(got.client_power.numpy(),
                               np.asarray(ref.client_power), rtol=0,
                               atol=1e-6 * jt.total_power)
    np.testing.assert_allclose(float(got.noise_std), float(ref.noise_std),
                               rtol=1e-6)


def test_cotaf_setup_matches_jax(topo):
    jt, tt = topo
    for snr in (None, 40.0):
        ref = jb.cotaf_setup(jt, jax.random.PRNGKey(0), snr_db=snr)
        got = tb.cotaf_setup(tt, snr_db=snr)
        assert int(got.server) == int(ref.server)
        np.testing.assert_allclose(got.client_power.numpy(),
                                   np.asarray(ref.client_power), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(float(got.noise_std),
                                   float(ref.noise_std), rtol=1e-6)


@pytest.mark.parametrize("server", [None, 2])
def test_cotaf_participation_matches_jax(server):
    rng = np.random.default_rng(5)
    mask = (rng.uniform(size=K) < 0.5).astype(np.float32)
    mask[2] = 0.0
    power = rng.uniform(0.1, 1.0, K).astype(np.float32)
    args = (power, 1.0, np.float32(0.1), server)
    ref = jb.cotaf_participation(
        jb.COTAFState(jnp.asarray(power), 1.0, jnp.float32(0.1),
                      None if server is None else jnp.asarray(server)),
        jnp.asarray(mask))
    state = cotaf_state_from_arrays(*args, device="cpu")
    np.testing.assert_array_equal(
        tb.cotaf_participation(state, _t(mask)).numpy(), np.asarray(ref))
    assert tb.cotaf_participation(state, None) is None


# ---------------------------------------------------------------------------
# The aggregates, JAX's noise replayed
# ---------------------------------------------------------------------------

MASKS = ["none", "mask", "all-masked"]


def _mask(case, seed=6):
    if case == "none":
        return None
    m = (np.random.default_rng(seed).uniform(size=K) < 0.5).astype(
        np.float32)
    m[0] = 1.0
    return np.zeros(K, np.float32) if case == "all-masked" else m


@pytest.mark.parametrize("case", MASKS)
def test_fedavg_aggregate_matches_jax(case):
    """The mask is FedAvg's weights; an all-masked round is 0/0 in both
    (the engine's receive fold discards it)."""
    tree = _stacked(7)
    m = _mask(case)
    ref = jb.fedavg_aggregate(jax.tree.map(jnp.asarray, tree),
                              None if m is None else jnp.asarray(m))
    got = tb.fedavg_aggregate(params_from_jax(tree, device="cpu"),
                              None if m is None else _t(m))
    for g, r in zip(got, ref):
        _assert_trees(g, r, equal_nan=case == "all-masked")
    if case == "all-masked":
        assert all(bool(torch.isnan(x).all()) for x in tree_leaves(got[1]))


@pytest.mark.parametrize("normalize,precode", [(True, True), (False, True),
                                               (True, False)])
@pytest.mark.parametrize("case", MASKS)
def test_cotaf_aggregate_matches_jax(topo, case, normalize, precode):
    jt, _ = topo
    state = jb.cotaf_setup(jt, jax.random.PRNGKey(0), snr_db=20.0)
    tstate = cotaf_state_from_arrays(state.client_power, state.total_power,
                                     state.noise_std, state.server,
                                     device="cpu")
    tree = _stacked(8)
    m = _mask(case)
    key = jax.random.PRNGKey(9)
    ref = jb.cotaf_aggregate(jax.tree.map(jnp.asarray, tree), state, key,
                             normalize=normalize, precode=precode,
                             mask=None if m is None else jnp.asarray(m))
    got = tb.cotaf_aggregate(params_from_jax(tree, device="cpu"), tstate,
                             _unit(key, tree, 1), normalize=normalize,
                             precode=precode,
                             mask=None if m is None else _t(m))
    for g, r in zip(got, ref):
        _assert_trees(g, r)
    np.testing.assert_array_equal(   # every client holds the one aggregate
        tree_leaves(got[0])[2].numpy(),
        np.broadcast_to(tree_leaves(got[1])[2].numpy(), (K, 7)))


@pytest.mark.parametrize("case", ["none", "mask"])
def test_decentralized_aggregate_matches_jax(topo, case):
    """The graph pruned of a round's absent nodes, as the strategy's
    ``state_from_view`` prunes it: absent nodes keep their params."""
    jt, _ = topo
    adj = np.asarray(jt.adjacency)
    m = _mask(case)
    if m is not None:
        mb = m > 0
        adj = adj & mb[:, None] & mb[None, :]
    state = jb.decentralized_state_from_graph(jnp.asarray(adj),
                                              jt.total_power, 1e-2)
    tstate = decentralized_state_from_arrays(state.mixing, state.noise_std,
                                             state.total_power,
                                             device="cpu")
    tree = _stacked(10)
    key = jax.random.PRNGKey(11)
    ref = jb.decentralized_aggregate(jax.tree.map(jnp.asarray, tree),
                                     state, key)
    got = tb.decentralized_aggregate(params_from_jax(tree, device="cpu"),
                                     tstate, _unit(key, tree, K))
    for g, r in zip(got, ref):
        _assert_trees(g, r)
    if m is not None:
        for g, x in zip(tree_leaves(got[0]), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(g.numpy()[m == 0], x[m == 0])


def test_baseline_syncs_go_through_the_ota_kernel(monkeypatch):
    """Every baseline sync is one call of `ota_aggregate` (one row of
    weights for FedAvg and COTAF, K for decentralized); CWFL's is none."""
    from repro_torch.core import baselines

    calls = []
    real = baselines.ota_aggregate

    def spy(signals, weights, noise):
        calls.append(tuple(weights.shape))
        return real(signals, weights, noise)

    monkeypatch.setattr(baselines, "ota_aggregate", spy)
    tree = params_from_jax(_stacked(12), device="cpu")
    d = sum(x[0].numel() for x in tree_leaves(tree))
    tb.fedavg_aggregate(tree)
    state = tb.cotaf_state_from_gains(
        torch.ones(K, K, dtype=torch.complex64), 1.0, 1e-2)
    tb.cotaf_aggregate(tree, state, torch.zeros(1, d))
    dstate = tb.decentralized_state_from_graph(
        ~torch.eye(K, dtype=torch.bool), 1.0, 1e-2)
    tb.decentralized_aggregate(tree, dstate, torch.zeros(K, d))
    assert calls == [(1, K), (1, K), (K, K)]


# ---------------------------------------------------------------------------
# The registry, its flags and the protocol's hooks
# ---------------------------------------------------------------------------

FLAGS = ("supports_client_sharding", "needs_graph", "water_fills",
         "reclusters")


def test_registry_matches_jax():
    assert available_strategies() == sorted(jax_available()) == [
        "cotaf", "cotaf_prox", "cwfl", "cwfl_prox", "decentralized",
        "fedavg"]
    for name in available_strategies():
        got, ref = get_strategy(name), jax_get_strategy(name)
        assert type(got).__name__ == type(ref).__name__, name
        assert got.mu_prox == ref.mu_prox, name
        for flag in FLAGS:
            assert getattr(got, flag) == getattr(ref, flag), (name, flag)
        for cfg_mu in (0.0, 0.3):
            assert got.effective_mu_prox(cfg_mu) == \
                ref.effective_mu_prox(cfg_mu)


@pytest.mark.parametrize("participants", [None, 3.0])
@pytest.mark.parametrize("num_clients,num_clusters", [(8, 3), (50, 4)])
def test_channel_uses_match_jax(num_clients, num_clusters, participants):
    for name in available_strategies():
        assert get_strategy(name).channel_uses(
            num_clients, num_clusters=num_clusters,
            participants=participants) == jax_get_strategy(
            name).channel_uses(num_clients, num_clusters=num_clusters,
                               participants=participants), name


def test_prox_variants_are_first_class():
    for base_name, prox_name in (("cwfl", "cwfl_prox"),
                                 ("cotaf", "cotaf_prox")):
        base, prox = get_strategy(base_name), get_strategy(prox_name)
        assert type(prox) is type(base)
        assert prox.mu_prox == PAPER_MU_PROX == 0.1 and base.mu_prox == 0.0
        assert prox.effective_mu_prox(0.0) == PAPER_MU_PROX
        assert prox.effective_mu_prox(0.3) == 0.3
        assert dataclasses.replace(prox, mu_prox=0.0) == dataclasses.replace(
            base, name=prox_name)


def test_protocol_defaults_match_jax(topo):
    """JAX's default hooks: ``receive_mask`` is the mask (decentralized:
    ``None``, no fold), ``on_head_failure`` hands the plan back,
    ``recluster`` raises for a strategy without a plan."""
    _, tt = topo
    view = ChannelView(link_gain=tt.link_gain, link_snr=tt.link_snr,
                       adjacency=tt.adjacency)
    mask = _t(_mask("mask"))
    alive = torch.ones(K)
    for cls in (COTAFStrategy, FedAvgStrategy, DecentralizedStrategy):
        s = cls(name="x")
        assert s.on_head_failure(None, None, view, alive) is None
        with pytest.raises(NotImplementedError, match="no cluster plan"):
            s.recluster(view, 3, 0)
    assert FedAvgStrategy(name="x").receive_mask(None, mask) is mask
    assert DecentralizedStrategy(name="x").receive_mask(None, mask) is None
    cotaf = get_strategy("cotaf")
    state = cotaf.init(tt, None, None, snr_db=40.0)
    recv = cotaf.receive_mask(state, mask)
    assert float(recv[int(state.server)]) == 1.0
    assert isinstance(get_strategy("cwfl").init(
        tt, type("D", (), {"kmeans_first": lambda self, k: 0})(),
        type("C", (), {"num_clusters": 3})()), CWFLState)


@pytest.mark.parametrize("name,rows", [("cwfl", None), ("cwfl_prox", None),
                                       ("cotaf", 1), ("cotaf_prox", 1),
                                       ("decentralized", K),
                                       ("fedavg", 0)])
def test_sync_noise_takes_the_shape_the_strategy_consumes(name, rows):
    """CWFL: two (C, d) matrices; COTAF one (1, d); decentralized one
    (K, d); FedAvg none — from the draw seam."""
    seen = []

    class Draws:
        def phase_noise(self, round_, c, d):
            seen.append(("phase", c, d))
            return torch.zeros(c, d), torch.zeros(c, d)

        def sync_noise(self, round_, r, d):
            seen.append(("sync", r, d))
            return torch.zeros(r, d)

    noise = get_strategy(name).sync_noise(Draws(), 0, K, 3, 25)
    if rows is None:
        assert seen == [("phase", 3, 25)] and len(noise) == 2
    elif rows == 0:
        assert seen == [] and noise is None
    else:
        assert seen == [("sync", rows, 25)]
        assert tuple(noise.shape) == (rows, 25)
