"""The compiled trajectory on the CPU: ``run_rounds(mode="scan")`` (the
round body on fixed buffers, eager here; captured into a CUDA graph on the
card) against ``mode="loop"``, the draws a round takes ahead, the
device-side K-means picks against the host-synced ones and JAX's, and the
phase timers.  K = 8, the MLP with one hidden layer of 32, a few rounds.
The port's scanned trajectory against JAX's is
tests/test_torch_slice.py's and tests/test_torch_scenarios.py's:
``run_federated`` takes the scan in both packages."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro.obs.profiling import PhaseTimers as JaxPhaseTimers
from repro_torch.core import clustering as tcl
from repro_torch.core.topology import TopologyConfig, make_topology
from repro_torch.models import small as tsmall
from repro_torch.obs import PhaseTimers
from repro_torch.sim import TorchDraws, get_scenario, run_rounds, take_round
from repro_torch.sim import engine as tengine
from repro_torch.strategies import get_strategy
from repro_torch.training import FLConfig
from repro_torch.training import federated as tfed
from repro_torch.utils.pytree import tree_leaves

K, ROUNDS, NUM_TRAIN, EVAL = 8, 3, 1920, 256
DYNAMIC = ("head-failure", "cluster-churn", "flaky-clients",
           "straggler-heavy", "mobile-fading")


def _mlp():
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    return init, apply, lambda p, x, y: tsmall.nll_loss(apply(p, x), y)


@pytest.fixture(scope="module")
def world():
    """The port's own K = 8 workload, drawn on the CPU."""
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_iid)

    topo = make_topology(7, TopologyConfig(num_clients=K), device="cpu")
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        0, SyntheticImageConfig.mnist_like(NUM_TRAIN, EVAL), device="cpu")
    xs, ys = partition_iid(1, xtr, ytr, K)
    return (*_mlp(), topo, xs, ys, xte, yte)


def _run(world, mode, strategy="cwfl", scenario=None, rounds=ROUNDS,
         **kwargs):
    cfg = FLConfig(strategy=strategy, rounds=rounds, eval_samples=EVAL,
                   lr=0.05)
    return run_rounds(*world, cfg, scenario=scenario,
                      topo_cfg=TopologyConfig(num_clients=K), mode=mode,
                      device="cpu", **kwargs)


def _assert_same(a, b):
    assert torch.equal(a["train_loss"], b["train_loss"])
    assert torch.equal(a["test_acc"], b["test_acc"])
    for x, y in zip(tree_leaves(a["final_params"]),
                    tree_leaves(b["final_params"])):
        assert torch.equal(x, y)
    assert a.keys() == b.keys()
    for k in a.get("scenario", {}):
        assert torch.equal(a["scenario"][k], b["scenario"][k]), k


# ---------------------------------------------------------------------------
# The draws of a round, taken ahead.
# ---------------------------------------------------------------------------

class _Recording:
    """A `Draws` that records every draw it hands out, in call order."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*args):
            out = fn(*args)
            self.calls.append((name, out))
            return out
        return call


def _flat(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    return [v for y in x for v in _flat(y)]


@pytest.mark.parametrize("strategy,scenario", [
    ("cwfl", "paper-static"), ("cotaf", "paper-static"),
    *(("cwfl", name) for name in DYNAMIC), ("cotaf", "mobile-fading")])
def test_round_draws_taken_ahead_are_the_loops(world, strategy, scenario):
    """The draws each run consumes (loop and scan alike) are, round by
    round and bit for bit, what `take_round` takes ahead from a fresh
    generator after the offline draws; the scanned run's first round (the
    warm-up) consumes its own round's draws and nothing more."""
    runs = {}
    for mode in ("loop", "scan"):
        rec = _Recording(TorchDraws(3, "cpu"))
        _run(world, mode, strategy, scenario, rounds=6, draws=rec)
        runs[mode] = rec.calls
    assert [n for n, _ in runs["loop"]] == [n for n, _ in runs["scan"]]
    for (_, a), (_, b) in zip(runs["loop"], runs["scan"]):
        assert all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))

    init, _, _, topo, xs, *_ = world
    sc, strat = get_scenario(scenario), get_strategy(strategy)
    fresh = TorchDraws(3, "cpu")
    offline = ["kmeans_first"] if strategy == "cwfl" else []
    offline += ["init_params"]
    for name in offline:
        getattr(fresh, name)(init if name == "init_params" else K)
    if sc.channel.evolves_geometry:
        fresh.channel_init(K)
    ahead = []
    for t in range(6):
        rd = take_round(
            fresh, t, strategy=strat, scenario=sc, num_clients=K, steps=3,
            batch=64, n_k=xs.shape[1], num_clusters=3, d=25_450,
            recluster=sc.recluster_every > 0 and t % sc.recluster_every == 0)
        ahead.extend(v for v in _flat(rd))
    drawn = [v for n, out in runs["loop"] if n not in
             ("kmeans_first", "init_params", "channel_init")
             for v in _flat(out)]
    assert len(drawn) == len(ahead)
    assert all(torch.equal(a, b) for a, b in zip(drawn, ahead))


# ---------------------------------------------------------------------------
# mode="scan" against mode="loop", and against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,scenario", [
    *(("cwfl", s) for s in ("paper-static",) + DYNAMIC),
    *((s, "paper-static") for s in ("fedavg", "cotaf", "decentralized",
                                    "cwfl_prox", "cotaf_prox")),
    ("cotaf", "flaky-clients"), ("decentralized", "straggler-heavy")])
def test_scan_equals_loop_bitwise(world, strategy, scenario):
    """Six rounds (cluster-churn re-clusters at rounds 0 and 5, the
    stragglers miss rounds 2 and 5): the same losses, accuracies, final
    params and scenario records, bit for bit, as JAX's scan and loop."""
    _assert_same(_run(world, "scan", strategy, scenario, rounds=6),
                 _run(world, "loop", strategy, scenario, rounds=6))


def test_mode_guards(world, tmp_path):
    """``progress`` needs the loop; the mode is one of two; the
    client-sharded round scans too, bitwise its loop (one gloo rank)."""
    from test_torch_dist import one_rank_group

    with pytest.raises(ValueError, match="mode='loop'"):
        _run(world, "scan", progress=lambda *_: None)
    with pytest.raises(ValueError, match="'scan' or 'loop'"):
        _run(world, "jit")
    with one_rank_group(tmp_path):
        _assert_same(_run(world, "scan", shard="clients"),
                     _run(world, "loop", shard="clients"))


def test_run_federated_picks_the_mode_as_jax(world, monkeypatch):
    """The scanned trajectory unless a live ``progress`` callback is
    given; an explicit ``mode`` wins."""
    seen = []
    real = tengine.run_rounds

    def spy(*args, **kwargs):
        seen.append(kwargs["mode"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tengine, "run_rounds", spy)
    cfg = FLConfig(rounds=2, eval_samples=EVAL)
    ticks = []
    a = tfed.run_federated(*world, cfg, device="cpu")
    b = tfed.run_federated(*world, cfg, device="cpu",
                           progress=lambda *r: ticks.append(r))
    tfed.run_federated(*world, cfg, device="cpu", mode="loop")
    assert seen == ["scan", "loop", "loop"] and len(ticks) == 2
    assert a["train_loss"] == b["train_loss"]
    assert a["test_acc"] == b["test_acc"]


def test_replayer_writes_the_carry_back_in_place(world):
    """The executor's buffers: a round reads the carry from them and
    writes its new carry into the same tensors (their storage does not
    move), and a result that is a view of a buffer is copied out before
    the write-back."""
    carry0 = {"x": torch.arange(4.0), "y": torch.zeros(())}

    def body(carry, draws, t):
        del t
        new = {"x": carry["x"] * 2 + draws[0], "y": carry["y"] + 1}
        return new, {"x_before": carry["x"][:2], "y": new["y"]}

    rep = tengine._Replayer(body, carry0, torch.device("cpu"))
    ptrs = [b.data_ptr() for b in rep.bufs]
    outs = [rep.run(t, (), lambda t=t: (torch.full((4,), float(t)),))
            for t in range(3)]
    assert [b.data_ptr() for b in rep.bufs] == ptrs
    x = torch.arange(4.0)
    for t, out in enumerate(outs):
        assert out["x_before"].tolist() == x[:2].tolist()
        x = x * 2 + t
        assert float(out["y"]) == t + 1
    assert rep.state()["x"].tolist() == x.tolist()


# ---------------------------------------------------------------------------
# K-means' picks on the device.
# ---------------------------------------------------------------------------

def _kmeans_with_ints(features, num_clusters, first, iters=50):
    """The host-synced K-means the port ran before (``int`` of each
    farthest-point pick), for the comparison."""
    C = num_clusters
    centers = [int(first)]
    for _ in range(1, C):
        d2 = torch.sum((features[:, None, :] - features[centers][None]) ** 2,
                       dim=-1)
        centers.append(int(torch.argmax(torch.min(d2, dim=1).values)))
    centroids = features[centers]
    for _ in range(iters):
        d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
        onehot = F.one_hot(torch.argmin(d2, dim=1), C).to(features.dtype)
        counts = torch.clamp(onehot.sum(0), min=1.0)
        new = (onehot.T @ features) / counts[:, None]
        empty = (onehot.sum(0) == 0)[:, None]
        centroids = torch.where(empty, centroids, new)
    d2 = torch.sum((features[:, None, :] - centroids[None]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1), centroids


def test_device_kmeans_elects_the_int_versions_heads(monkeypatch):
    """Over 90 topologies (K = 8, 16, 50; C = 2, 3, 5; every first
    centre a 0-d tensor): the same assignment, centroids and heads as the
    K-means whose picks went through the host, and JAX's heads on JAX's
    features for the same first centre."""
    plans = []
    for K_ in (8, 16, 50):
        for seed in range(10):
            topo = make_topology(seed, TopologyConfig(num_clients=K_),
                                 device="cpu")
            for C in (2, 3, 5):
                first = torch.randint(K_, (), generator=torch.Generator()
                                      .manual_seed(seed))
                plans.append((topo, C, first))
    new = [tcl.make_cluster_plan(t.link_snr, t.adjacency, C, f)
           for t, C, f in plans]
    monkeypatch.setattr(tcl, "_kmeans", _kmeans_with_ints)
    old = [tcl.make_cluster_plan(t.link_snr, t.adjacency, C, int(f))
           for t, C, f in plans]
    for a, b in zip(new, old):
        for field in ("assignment", "heads", "membership", "cluster_snr",
                      "head_mask"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field
    # And JAX's clusters on JAX's features (K = 16), from the first centre
    # JAX's key draws.
    jt = jtopo.make_topology(jax.random.PRNGKey(4),
                             jtopo.TopologyConfig(num_clients=16))
    feats = jcl.snr_features(jt.link_snr, jt.adjacency)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref_assign, _ = jcl._kmeans(feats, 3, key)
        got_assign, _ = tcl._kmeans(
            torch.from_numpy(np.array(feats)), 3,
            torch.tensor(int(jax.random.randint(key, (), 0, 16))))
        np.testing.assert_array_equal(got_assign.numpy(),
                                      np.asarray(ref_assign))


# ---------------------------------------------------------------------------
# The phase timers.
# ---------------------------------------------------------------------------

def test_phase_timers_record_both_phases(world):
    """``trace_compile`` (the warm-up round; the captures on the card)
    and ``execute`` (the rest) in scan mode, ``execute`` alone in loop
    mode; the copy keeps JAX's interface."""
    scan, loop = PhaseTimers(), PhaseTimers()
    _run(world, "scan", timers=scan)
    _run(world, "loop", timers=loop)
    assert set(scan.seconds) == {"trace_compile", "execute"}
    assert set(loop.seconds) == {"execute"}
    assert all(v > 0 for v in scan.seconds.values())
    jax_timers = JaxPhaseTimers()
    with jax_timers.phase("execute"):
        pass
    assert set(dir(jax_timers)) <= set(dir(scan)) | {"__weakref__"}
    assert list(scan.as_dict()) == sorted(scan.seconds)
    with scan.phase("execute"):
        pass
    assert scan.seconds["execute"] > 0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from repro_torch.obs import profiler_trace

    with profiler_trace(None) as prof:
        assert prof is None
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").exists()


def test_take_round_draws_nothing_a_scenario_does_not_use():
    """The static round draws its batches and its noise and nothing of
    the scenario stream; a dynamic round each of its kinds, the
    re-clustering centre only when asked."""
    strat = get_strategy("cwfl")
    d = TorchDraws(0, "cpu")
    rd = take_round(d, 0, strategy=strat, scenario=get_scenario(
        "paper-static"), num_clients=K, steps=2, batch=4, n_k=30,
        num_clusters=3, d=50)
    assert rd.idx.shape == (K, 2, 4) and len(rd.noise) == 2
    assert all(getattr(rd, f) is None for f in
               ("channel", "schedule", "faults", "csi", "recluster"))
    churn = take_round(d, 0, strategy=strat,
                       scenario=get_scenario("cluster-churn"),
                       num_clients=K, steps=2, batch=4, n_k=30,
                       num_clusters=3, d=50, recluster=True)
    assert churn.channel is not None and churn.recluster.shape == ()
    assert churn.recluster.dtype == torch.int64
    assert churn.schedule is None and churn.faults is None
    sc = dataclasses.replace(get_scenario("flaky-clients"))
    flaky = take_round(d, 1, strategy=strat, scenario=sc, num_clients=K,
                       steps=2, batch=4, n_k=30, num_clusters=3, d=50)
    assert flaky.schedule.shape == (K,) and flaky.faults is not None
