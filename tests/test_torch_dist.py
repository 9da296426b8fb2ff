"""The port's distribution layer (`repro_torch.dist`, `repro_torch.sim.
sharded`) against the JAX package's (`repro.dist`, `repro.sim.sharded`).

Single-process cases: the flat phase-1 MAC and the flat round, the FL plan
on carried-over draws, the shard-mode loss weights and noise.  Multi-rank
cases: the collectives run in several ``gloo`` processes
(``torch.multiprocessing.spawn``, a ``file://`` store in ``tmp_path``),
and the reference runs in this process — JAX's collectives under a named
``vmap`` (``axis_name`` stands in for the mesh axis), its trajectories on
one device.  Every rendezvous and join has its own timeout, so a hung rank
fails its test and not the suite.

The noise of both packages is the same: JAX's normals, rebuilt from its
keys with its own splits, are handed to the port as unit normals."""
import contextlib
import dataclasses
import datetime
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import cwfl as jcwfl
from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.dist import fl_integration as jfl
from repro.dist import ota_collectives as joc
from repro.models import small as jsmall
from repro.sim import run_rounds as jax_run_rounds
from repro.sim.sharded import _client_sharded_sync as jax_sharded_sync
from repro.strategies import get_strategy as jax_get_strategy
from repro.training import FLConfig as JaxFLConfig
from repro.utils import tree_add_noise as jax_tree_add_noise
from repro.utils import tree_flatten_vector as jax_flatten_vector
from repro_torch.convert import (cwfl_state_from_arrays,
                                 fl_plan_from_arrays, params_from_jax,
                                 topology_from_arrays)
from repro_torch.core import cwfl as tcwfl
from repro_torch.core.topology import Topology, TopologyConfig
from repro_torch.dist import fl_integration as tfl
from repro_torch.dist import ota_collectives as toc
from repro_torch.models import small as tsmall
from repro_torch.sim import Scenario, run_rounds
from repro_torch.sim.processes import ChannelProcessConfig
from repro_torch.sim.sharded import (_client_sharded_sync,
                                     run_rounds_client_sharded)
from repro_torch.strategies import CWFLStrategy, Strategy, get_strategy
from repro_torch.training import FLConfig
from repro_torch.utils.pytree import (tree_flatten_vector, tree_leaves,
                                      tree_unflatten_vector)

# f32 sums in another order than XLA's (the MAC, the precoding powers, the
# collective's reduction): JAX's own flat-route checks hold 1e-5.
ATOL = 1e-5
# The plan's float64 budget from f32 state arrays (water-filling and SNRs
# rounded otherwise than XLA's): relative 1e-5.
PLAN_RTOL = 1e-5
RENDEZVOUS_S = 60     # init_process_group's timeout in each rank
JOIN_S = 240          # the most a spawned group may take to finish


# ---------------------------------------------------------------------------
# Carrying JAX's objects across.
# ---------------------------------------------------------------------------

def _carry_state(jstate) -> tcwfl.CWFLState:
    p = jstate.plan
    return cwfl_state_from_arrays(
        [np.asarray(x) for x in (p.assignment, p.heads, p.membership,
                                 p.cluster_snr, p.head_mask)],
        *(np.asarray(getattr(jstate, name)) for name in (
            "client_power", "total_power", "head_noise_std",
            "consensus_noise_std", "mix")), device="cpu")


def _carry_plan(jplan) -> tfl.FLPlan:
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan) if f.name != "state"}
    return fl_plan_from_arrays(fields, _carry_state(jplan.state))


def _normals(key, *shapes):
    """JAX's unit normals for each shape, one split key each, as torch."""
    keys = jax.random.split(key, len(shapes))
    return tuple(torch.from_numpy(np.array(jax.random.normal(
        k, s, jnp.float32))) for k, s in zip(keys, shapes))


@pytest.fixture(scope="module")
def state12():
    """JAX's flat-route fixture (tests/test_ota_collectives.py): K=12,
    three hotspots, C=3, 40 dB."""
    topo = jtopo.make_topology(jax.random.PRNGKey(0), jtopo.TopologyConfig(
        num_clients=12, num_hotspots=3))
    jstate = jcwfl.setup(topo, jcwfl.CWFLConfig(num_clusters=3, snr_db=40.0),
                         jax.random.PRNGKey(1))
    return jstate, _carry_state(jstate)


# ---------------------------------------------------------------------------
# Flat routes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [300, 1000, 2048])
def test_phase1_ota_flat_matches_jax(state12, d):
    """Phase 1 on the flat (K, d) matrix, JAX's phase-1 normals replayed,
    against both JAX routes (its Pallas kernel in interpret mode and its
    jnp oracle)."""
    jstate, tstate = state12
    K, C = jstate.num_clients, jstate.num_clusters
    s = np.random.default_rng(d).standard_normal((K, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    unit = torch.from_numpy(np.array(jax.random.normal(key, (C, d),
                                                       jnp.float32)))
    got = toc.phase1_ota_flat(torch.from_numpy(s), tstate, unit)
    assert got.shape == (C, d) and got.dtype == torch.float32
    for use_pallas in (True, False):
        ref = joc.phase1_ota_flat(jnp.asarray(s), jstate, key,
                                  use_pallas=use_pallas, tile=512)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=ATOL)


def _noiseless(jstate):
    return dataclasses.replace(
        jstate, head_noise_std=jstate.head_noise_std * 0.0,
        consensus_noise_std=jstate.consensus_noise_std * 0.0)


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "noisy"])
def test_cwfl_aggregate_flat_matches_jax(state12, noisy):
    """The full flat round against JAX's, noiseless and with JAX's two
    phase normals injected; and against the port's own tree route
    (`cwfl.aggregate`) on the same normals."""
    jstate = state12[0] if noisy else _noiseless(state12[0])
    tstate = _carry_state(jstate)
    K, C = jstate.num_clients, jstate.num_clusters
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((K, 37, 5)).astype(np.float32),
            "b": rng.standard_normal((K, 11)).astype(np.float32)}
    flat = np.array(jax.vmap(jax_flatten_vector)(tree))         # (K, d)
    key = jax.random.PRNGKey(6)
    noise = _normals(key, (C, flat.shape[1]), (C, flat.shape[1]))
    new, cons = toc.cwfl_aggregate_flat(torch.from_numpy(flat), tstate,
                                        noise)
    ref_new, ref_cons = joc.cwfl_aggregate_flat(jnp.asarray(flat), jstate,
                                                key)
    np.testing.assert_allclose(new.numpy(), np.asarray(ref_new), atol=ATOL)
    np.testing.assert_allclose(cons.numpy(), np.asarray(ref_cons),
                               atol=ATOL)
    tree_new, tree_cons = tcwfl.aggregate({"flat": torch.from_numpy(flat)},
                                          tstate, noise)
    np.testing.assert_allclose(new.numpy(), tree_new["flat"].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(cons.numpy(), tree_cons["flat"].numpy(),
                               atol=ATOL)


def test_flat_routes_refuse_literal_weights(state12):
    _, tstate = state12
    s = torch.zeros(12, 8)
    with pytest.raises(NotImplementedError, match="normalize"):
        toc.phase1_ota_flat(s, tstate, torch.zeros(3, 8), normalize=False)
    with pytest.raises(NotImplementedError, match="precode"):
        toc.cwfl_aggregate_flat(s, tstate, (torch.zeros(3, 8),) * 2,
                                precode=False)


def test_round_coefficients_take_gathered_powers(state12):
    """``mean_sq`` in place of the signals (the sharded sync's route)
    gives JAX's coefficients; without either it raises."""
    jstate, tstate = state12
    s = np.random.default_rng(9).standard_normal((12, 40)).astype(np.float32)
    mean_sq = np.mean(s * s, axis=1)
    ref = jcwfl.round_coefficients(jstate, None, mean_sq=jnp.asarray(mean_sq))
    got = tcwfl.round_coefficients(tstate, mean_sq=torch.from_numpy(mean_sq))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="mean_sq"):
        tcwfl.round_coefficients(tstate)


# ---------------------------------------------------------------------------
# The FL plan.
# ---------------------------------------------------------------------------

class _FirstCentre:
    """The draw seam's K-means first centre, replayed."""

    def __init__(self, first):
        self.first = first

    def kmeans_first(self, num_clients):
        return self.first


def _jax_plan_draws(K, C, key):
    """JAX's make_fl_plan draws, carried over: its topology (from the
    first key of the split) and K-means' first centre (from the second)."""
    k_topo, k_setup = jax.random.split(key)
    cfg = jtopo.TopologyConfig(num_clients=K,
                               num_hotspots=max(min(C, K), 1))
    topo = jtopo.make_topology(k_topo, cfg)
    return topo, int(jax.random.randint(k_setup, (), 0, K))


def _port_plan(topo, first, K, C, snr):
    """The port's plan on JAX's topology, its link SNRs as JAX computed
    them: ATen's ``log10`` rounds otherwise than XLA's, and those bits
    decide the head of a two-member cluster, an exact tie (ROADMAP §3)."""
    ttopo = Topology(**{name: torch.from_numpy(np.array(getattr(topo, name)))
                        for name in ("positions", "link_gain", "link_snr",
                                     "adjacency")},
                     noise_var=topo.noise_var, total_power=topo.total_power)
    return tfl.make_fl_plan(K, C, snr_db=snr, topology=ttopo,
                            draws=_FirstCentre(first), device="cpu")


def _assert_plans_match(got, ref):
    assert (got.num_clients, got.num_clusters) == (ref.num_clients,
                                                   ref.num_clusters)
    np.testing.assert_array_equal(got.assignment, ref.assignment)
    np.testing.assert_array_equal(got.heads, ref.heads)
    for name in ("beta", "mix", "cluster_weights", "phase1_rel_std",
                 "phase2_rel_std"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=PLAN_RTOL, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(got.noise_std, ref.noise_std, rtol=PLAN_RTOL)
    assert got.snr_db == ref.snr_db


@pytest.mark.parametrize("K,C,snr", [(16, 4, 40.0), (8, 3, 40.0),
                                     (4, 2, 40.0), (1, 1, 40.0),
                                     (16, 4, 10.0), (16, 4, 30.0),
                                     (16, 4, 50.0)])
def test_make_fl_plan_matches_jax(K, C, snr):
    key = jax.random.PRNGKey(0)
    ref = jfl.make_fl_plan(K, C, key, snr_db=snr)
    got = _port_plan(*_jax_plan_draws(K, C, key), K, C, snr)
    _assert_plans_match(got, ref)
    np.testing.assert_allclose(got.beta.sum(), 1.0, rtol=1e-6)


def test_make_fl_plan_retries_empty_clusters_as_jax(monkeypatch):
    """Every link in outage: all SNR features are floored alike, K-means
    puts every client in one cluster, and both packages retry with the
    clusters they filled (one)."""
    K, C = 4, 3
    cfg = jtopo.TopologyConfig(num_clients=K, num_hotspots=C)
    topo = jtopo.make_topology(jax.random.PRNGKey(5), cfg)
    dead = jnp.zeros((K, K), jnp.complex64)
    snr, adjacency = jtopo.link_stats(dead, cfg)
    topo = dataclasses.replace(topo, link_gain=dead, link_snr=snr,
                               adjacency=adjacency)
    monkeypatch.setattr(jfl, "make_topology", lambda key, cfg: topo)
    key = jax.random.PRNGKey(1)
    ref = jfl.make_fl_plan(K, C, key)
    assert ref.num_clusters == 1
    first = int(jax.random.randint(jax.random.split(key)[1], (), 0, K))
    _assert_plans_match(_port_plan(topo, first, K, C, 40.0), ref)


def test_make_fl_plan_draws_its_own():
    """Without carried draws the plan draws topology and first centre from
    ``seed``: the same seed gives the same plan, and it is a plan."""
    a, b = (tfl.make_fl_plan(16, 4, seed=3, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(a.assignment, b.assignment)
    assert a.noise_std == b.noise_std > 0.0
    np.testing.assert_allclose(a.beta.sum(), 1.0, rtol=1e-6)
    assert a.num_clusters == 4 and a.state.num_clients == 16


@pytest.mark.parametrize("n", [256, 16, 7, 3])
def test_example_weights_match_jax(n):
    """Mean-1 loss weights, including a batch smaller than the client
    count (β renormalized over the clients present)."""
    ref = jfl.make_fl_plan(16, 4, jax.random.PRNGKey(0))
    got = _carry_plan(ref)
    np.testing.assert_array_equal(got.client_of_example(n),
                                  ref.client_of_example(n))
    np.testing.assert_allclose(got.example_weights(n),
                               ref.example_weights(n), rtol=1e-12)
    np.testing.assert_allclose(got.example_weights(n).mean(), 1.0,
                               rtol=1e-6)


def test_example_weights_zero_mass_fallback_matches_jax():
    """Every present client with β = 0: uniform weights, as JAX."""
    ref = jfl.make_fl_plan(16, 4, jax.random.PRNGKey(0))
    beta = ref.beta.copy()
    beta[ref.client_of_example(3)] = 0.0
    ref = dataclasses.replace(ref, beta=beta)
    got = _carry_plan(ref)
    np.testing.assert_array_equal(got.example_weights(3),
                                  ref.example_weights(3))
    np.testing.assert_array_equal(got.example_weights(3), np.ones(3))


def test_add_channel_noise_matches_jax():
    """A zero std is a no-op that draws nothing; otherwise JAX's per-leaf
    normals (one split key a leaf) replayed give JAX's noisy tree."""
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal((3,)).astype(np.float32)}
    tgrads = params_from_jax(grads, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    for zero in (0.0, 0):
        assert tfl.add_channel_noise(tgrads, gen, zero) is tgrads
    assert torch.equal(gen.get_state(), state)
    key = jax.random.PRNGKey(4)
    ref = jax_tree_add_noise(jax.tree.map(jnp.asarray, grads), key, 0.3)
    leaves = jax.tree.leaves(grads)
    normals = _normals(key, *(x.shape for x in leaves))
    got = tfl.add_channel_noise(tgrads, list(normals), 0.3)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    drawn = tfl.add_channel_noise(tgrads, gen, 0.3)
    assert all(a.shape == b.shape and not torch.equal(a, b) for a, b in
               zip(tree_leaves(drawn), tree_leaves(tgrads)))


def test_vector_flattening_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"fc10": {"w": rng.standard_normal((2, 3)).astype(np.float32)},
            "fc2": {"b": rng.standard_normal((4,)).astype(np.float32)}}
    got = tree_flatten_vector(params_from_jax(tree, device="cpu"))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_flatten_vector(tree)))
    back = tree_unflatten_vector(got, params_from_jax(tree, device="cpu"))
    for a, b in zip(tree_leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_client_sharding_flag_matches_jax():
    assert Strategy.supports_client_sharding is False
    assert get_strategy("cwfl").supports_client_sharding is True
    assert (get_strategy("cwfl").supports_client_sharding
            == jax_get_strategy("cwfl").supports_client_sharding)


# ---------------------------------------------------------------------------
# Multi-rank harness.
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, store, out, job, payload):
    """One rank: join the gloo group, run ``job``, leave the group, and
    write what ``job`` returned where the parent reads it."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    try:
        result = job(rank, world, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process, for the length
    of the block."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'one-rank-store'}",
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spawn(job, world, payload, tmp_path):
    """``job(rank, world, payload)`` in ``world`` gloo processes; returns
    each rank's result.  A rank that raises fails the test with its
    traceback; ranks still running after ``JOIN_S`` are killed."""
    ctx = mp.spawn(_rank_entry, nprocs=world, join=False, args=(
        world, str(tmp_path / "store"), str(tmp_path), job, payload))
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            pytest.fail(f"{world} ranks did not finish within {JOIN_S} s")
    results = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# The hierarchical collective, four ranks.
# ---------------------------------------------------------------------------

def _collective_job(rank, world, p):
    """Each rank one client: the collective on its array, the tree
    collective on its slice of the stacked tree, and the group-size
    check against an 8-client plan."""
    out = {"x": tfl.hierarchical_ota_allreduce(
        torch.from_numpy(p["xs"][rank]), p["plan"], p["noise_x"]).numpy()}
    agg = toc.build_gradient_allreduce(p["plan"])
    local = {k: torch.from_numpy(v[rank:rank + 1])
             for k, v in p["tree"].items()}
    out["tree"] = {k: v.numpy() for k, v in agg(local, p["noise_tree"])
                   .items()}
    errors = []
    for call in (lambda: tfl.hierarchical_ota_allreduce(
                     torch.from_numpy(p["xs"][rank]), p["plan8"],
                     p["noise_x"]),
                 lambda: toc.build_gradient_allreduce(p["plan8"])):
        try:
            call()
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    return out


def test_hierarchical_collective_across_four_ranks(tmp_path):
    """Four gloo ranks, one client each, at 10 dB so the channel noise
    shows: every rank returns the same bits, and they are JAX's
    collective (under a named vmap) on the same normals; the tree
    collective likewise; a plan of another client count raises."""
    K, C = 4, 2
    jplan = jfl.make_fl_plan(K, C, jax.random.PRNGKey(0), snr_db=10.0)
    assert jplan.num_clusters == C and jplan.noise_std > 1e-3
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((K, 5, 3)).astype(np.float32)
    tree = {"w": rng.standard_normal((K, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}
    key_x, key_t = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    ref_x = jax.vmap(lambda x: jfl.hierarchical_ota_allreduce(
        x, jplan, key_x, "data"), axis_name="data")(jnp.asarray(xs))
    ref_tree = jax.vmap(lambda t: joc.ota_allreduce_tree(
        t, jplan, key_t, "data"), axis_name="data")(
        jax.tree.map(jnp.asarray, tree))
    d = 5 * 3 + 7
    payload = {"xs": xs, "tree": tree, "plan": _carry_plan(jplan),
               "plan8": _carry_plan(jfl.make_fl_plan(
                   8, 3, jax.random.PRNGKey(0))),
               "noise_x": _normals(key_x, (C, 5, 3), (C, 5, 3)),
               "noise_tree": _normals(key_t, (C, d), (C, d))}
    ranks = _spawn(_collective_job, K, payload, tmp_path)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["x"], ranks[0]["x"])
        np.testing.assert_allclose(got["x"], np.asarray(ref_x[r]),
                                   atol=ATOL)
        for name in ("w", "b"):
            assert got["tree"][name].shape == (1,) + tree[name].shape[1:]
            np.testing.assert_array_equal(got["tree"][name],
                                          ranks[0]["tree"][name])
            np.testing.assert_allclose(got["tree"][name][0],
                                       np.asarray(ref_tree[name][r]),
                                       atol=ATOL)
        assert len(got["errors"]) == 2
        assert all("plan has 8 clients but the process group has 4 ranks"
                   in e for e in got["errors"])


# ---------------------------------------------------------------------------
# The client-sharded engine, two ranks.
# ---------------------------------------------------------------------------

K8, C3, ROUNDS, NUM_TRAIN, EVAL = 8, 3, 3, 1920, 256


class _ReplayDraws:
    """The JAX engine's draws for one run (key chain as in
    tests/test_torch_slice.py), precomputed so that ranks can replay
    them."""

    def __init__(self, jinit, cfg, n_k, steps):
        k_state, k_init, k_rounds = jax.random.split(
            jax.random.PRNGKey(cfg.seed), 3)
        self.first = int(jax.random.randint(k_state, (), 0, K8))
        self.params = jax.tree.map(np.asarray, jinit(k_init))
        leaves = [np.broadcast_to(x, (K8,) + x.shape)
                  for x in jax.tree.leaves(self.params)]
        ones = jnp.ones((C3,), jnp.float32)
        self.idx, self.noise = [], []
        for rkey in jax.random.split(k_rounds, cfg.rounds):
            k_local, k_agg = jax.random.split(rkey)
            self.idx.append(np.stack([np.stack([
                np.asarray(jax.random.randint(k, (cfg.batch_size,), 0, n_k))
                for k in jax.random.split(ck, steps)])
                for ck in jax.random.split(k_local, K8)]))
            self.noise.append(tuple(
                np.asarray(jcwfl._flat_leaf_noise(k, leaves, C3, ones))
                for k in jax.random.split(k_agg)))

    def kmeans_first(self, num_clients):
        return self.first

    def init_params(self, init_fn):
        return params_from_jax(self.params, device="cpu")

    def batch_indices(self, round_, num_clients, steps, batch, n_k):
        return torch.from_numpy(np.array(self.idx[round_]))

    def phase_noise(self, round_, num_clusters, d):
        return tuple(torch.from_numpy(np.array(x))
                     for x in self.noise[round_])


def _mlp():
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    return init, apply, lambda p, x, y: tsmall.nll_loss(apply(p, x), y)


def _sharded_job(rank, world, p):
    """The sharded sync on this rank's clients; a short run of
    ``run_rounds(shard="clients")``, with ``cwfl`` and with ``cwfl_prox``;
    the divisibility guard."""
    local = {k: {n: torch.from_numpy(v[rank * 4:(rank + 1) * 4])
                 for n, v in sub.items()} for k, sub in p["tree"].items()}
    new, cons = _client_sharded_sync(local, p["state"], p["sync_noise"])
    out = {"sync_new": [x.numpy() for x in tree_leaves(new)],
           "sync_cons": [x.numpy() for x in tree_leaves(cons)]}
    init, apply, loss = _mlp()
    topo = topology_from_arrays(*p["topo"], TopologyConfig(num_clients=K8),
                                device="cpu")
    xs, ys, xte, yte = (torch.from_numpy(a) for a in p["data"])
    h = run_rounds(init, apply, loss, topo, xs, ys, xte, yte, p["cfg"],
                   draws=p["draws"], device="cpu", shard="clients",
                   mode="loop")
    out["train_loss"] = h["train_loss"].numpy()
    out["test_acc"] = h["test_acc"].numpy()
    out["final_params"] = [x.numpy() for x in tree_leaves(h["final_params"])]
    prox = run_rounds(init, apply, loss, topo, xs, ys, xte, yte,
                      dataclasses.replace(p["cfg"], strategy="cwfl_prox"),
                      draws=p["draws"], device="cpu", shard="clients",
                      mode="loop")
    out["prox_train_loss"] = prox["train_loss"].numpy()
    try:
        run_rounds(init, apply, loss, topo, xs[:7], ys[:7], xte, yte,
                   p["cfg"], draws=p["draws"], device="cpu",
                   shard="clients", mode="loop")
    except ValueError as exc:
        out["divisibility"] = str(exc)
    return out


@pytest.fixture(scope="module")
def fl_workload():
    """tests/test_torch_slice.py's protocol: K=8, hidden 32, C=3, 40 dB,
    3 rounds of 3 local steps."""
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=NUM_TRAIN,
                                                 num_test=EVAL)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(1), xtr, ytr, K8)
    topo = jtopo.make_topology(jax.random.PRNGKey(7),
                               jtopo.TopologyConfig(num_clients=K8))
    return topo, tuple(np.array(a) for a in (xs, ys, xte, yte))


def test_client_sharded_across_two_ranks(fl_workload, tmp_path):
    """Two gloo ranks of four clients each.

    The sharded sync against JAX's `_client_sharded_sync` under a named
    vmap, on JAX's state and normals (abs 1e-5).  ``run_rounds(...,
    shard="clients")`` with JAX's draws replayed: against the port's
    unsharded run with JAX's own sharded-vs-unsharded tolerances (loss
    rtol 1e-5 / atol 1e-6, accuracy 1e-2, params rtol 1e-5 / atol 1e-6;
    tests/test_sim_sharded.py), and against JAX's unsharded run with the
    slice's cross-package tolerances (loss rtol 1e-4, accuracy 2/256,
    params 1e-4; tests/test_torch_slice.py).  JAX's own sharded run needs
    ``shard_map(check_rep=)``, which the installed jax no longer takes,
    so JAX's unsharded run is the reference its own test holds it to."""
    topo, data = fl_workload
    # The sync, on JAX's K=8 state and a stacked tree of two leaves.
    jstate = jcwfl.setup(topo, jcwfl.CWFLConfig(num_clusters=C3,
                                                snr_db=40.0),
                         jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    tree = {"fc0": {"w": rng.standard_normal((K8, 6, 4)).astype(np.float32),
                    "b": rng.standard_normal((K8, 4)).astype(np.float32)}}
    key = jax.random.PRNGKey(9)
    ref_new, ref_cons = jax.vmap(
        lambda t: jax_sharded_sync(t, jstate, key, "clients"),
        axis_name="clients")(jax.tree.map(
            lambda x: jnp.asarray(x).reshape((2, 4) + x.shape[1:]), tree))
    local_leaves = [x[:4] for x in jax.tree.leaves(tree)]
    ones = jnp.ones((C3,), jnp.float32)
    sync_noise = tuple(torch.from_numpy(np.array(jcwfl._flat_leaf_noise(
        k, local_leaves, C3, ones))) for k in jax.random.split(key))

    # The trajectory, on the slice's protocol.
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jcfg = JaxFLConfig(rounds=ROUNDS, snr_db=40.0, eval_samples=EVAL, seed=0)
    xs, ys, xte, yte = data
    ref = jax_run_rounds(jinit, japply,
                         lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
                         topo, *(jnp.asarray(a) for a in data), jcfg)
    steps = xs.shape[1] // jcfg.batch_size
    draws = _ReplayDraws(jinit, jcfg, xs.shape[1], steps)
    cfg = FLConfig(rounds=ROUNDS, snr_db=40.0, eval_samples=EVAL, seed=0)
    init, apply, loss = _mlp()
    topo_arrays = (np.asarray(topo.positions), np.asarray(topo.link_gain))
    ttopo = topology_from_arrays(*topo_arrays,
                                 TopologyConfig(num_clients=K8),
                                 device="cpu")
    unsharded = run_rounds(init, apply, loss, ttopo,
                           *(torch.from_numpy(a) for a in data), cfg,
                           draws=draws, device="cpu")
    # CWFL-Prox shares the sharded run's local runner (FedProx's µ_p).
    unsharded_prox = run_rounds(
        init, apply, loss, ttopo, *(torch.from_numpy(a) for a in data),
        dataclasses.replace(cfg, strategy="cwfl_prox"), draws=draws,
        device="cpu")

    ranks = _spawn(_sharded_job, 2, {
        "tree": tree, "state": _carry_state(jstate),
        "sync_noise": sync_noise, "topo": topo_arrays, "data": data,
        "cfg": cfg, "draws": draws}, tmp_path)

    for r, got in enumerate(ranks):
        for a, b in zip(got["sync_new"], jax.tree.leaves(ref_new)):
            np.testing.assert_allclose(a, np.asarray(b[r]), atol=ATOL)
        for a, b in zip(got["sync_cons"], jax.tree.leaves(ref_cons)):
            np.testing.assert_allclose(a, np.asarray(b[r]), atol=ATOL)
        np.testing.assert_array_equal(got["train_loss"],
                                      ranks[0]["train_loss"])
        np.testing.assert_allclose(got["train_loss"],
                                   unsharded["train_loss"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["test_acc"],
                                   unsharded["test_acc"].numpy(), atol=1e-2)
        np.testing.assert_allclose(got["prox_train_loss"],
                                   unsharded_prox["train_loss"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert not np.allclose(got["prox_train_loss"], got["train_loss"],
                               rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["train_loss"],
                                   np.asarray(ref["train_loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["test_acc"],
                                   np.asarray(ref["test_acc"]),
                                   atol=2 / EVAL)
        for a, b, c in zip(got["final_params"],
                           tree_leaves(unsharded["final_params"]),
                           jax.tree.leaves(ref["final_params"])):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a, np.asarray(c), atol=1e-4)
        assert got["divisibility"] == ("K=7 clients must divide over the 2 "
                                       "ranks of the process group")


def test_client_sharded_guards(fl_workload, tmp_path):
    """JAX's guards, checked before any collective: another shard than
    "clients", a dynamic scenario, a strategy without the capability
    flag; then no process group and the unported options.  In a group of
    one rank the default scanned mode runs, bitwise the loop."""
    topo, data = fl_workload
    init, apply, loss = _mlp()
    ttopo = topology_from_arrays(np.asarray(topo.positions),
                                 np.asarray(topo.link_gain),
                                 TopologyConfig(num_clients=K8),
                                 device="cpu")
    args = (init, apply, loss, ttopo, *(torch.from_numpy(a) for a in data))
    cfg = FLConfig(rounds=1, eval_samples=64)
    with pytest.raises(ValueError, match="shard='clients'"):
        run_rounds(*args, cfg, device="cpu", shard="mc")
    csi = Scenario(name="csi",
                   channel=ChannelProcessConfig(csi_error_std=0.3))
    with pytest.raises(NotImplementedError, match="static"):
        run_rounds(*args, cfg, scenario=csi, device="cpu", shard="clients",
                   mode="loop")

    @dataclasses.dataclass(frozen=True)
    class UnshardedCWFL(CWFLStrategy):
        supports_client_sharding = False

    with pytest.raises(NotImplementedError, match="UnshardedCWFL"):
        run_rounds(*args, dataclasses.replace(
            cfg, strategy=UnshardedCWFL(name="unsharded")), device="cpu",
            shard="clients", mode="loop")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        run_rounds(*args, cfg, device="cpu", shard="clients", mode="loop")
    with one_rank_group(tmp_path):
        scan = run_rounds(*args, cfg, device="cpu", shard="clients")
        loop = run_rounds(*args, cfg, device="cpu", shard="clients",
                          mode="loop")
    assert torch.equal(scan["train_loss"], loop["train_loss"])
    assert torch.equal(scan["test_acc"], loop["test_acc"])
    for kw in ({"telemetry": True}, {"checkpoint_dir": "ckpt"},
               {"resume": True}, {"stop_after": 1}, {"stream": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 5"):
            run_rounds_client_sharded(*args, cfg, device="cpu", **kw)
