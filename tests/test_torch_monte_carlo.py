"""The batched Monte-Carlo sweep on the CPU: the trajectory axis of kernels
1 and 3 (plain versions and the wrappers' CPU route) against ``jax.vmap``
of JAX's Pallas kernels in interpret mode and of its oracle; the batched
launch plan; ``run_monte_carlo`` against JAX's on JAX's draws, each
batched element against the port's lone run, and ``shard="mc"`` over two
gloo processes against the unsharded sweep.  K = 8, the MLP with one
hidden layer of 32, 2 rounds."""
import ctypes
import dataclasses
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.kernels.cwfl_round import cwfl_round as jax_cwfl_round
from repro.kernels.ota_aggregate import ota_aggregate as jax_ota
from repro.kernels.ref import cwfl_round_ref as jax_cwfl_round_ref
from repro.kernels.ref import ota_aggregate_ref as jax_ota_ref
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.training import FLConfig as JaxFLConfig
from repro_torch.convert import topology_from_arrays
from repro_torch.core import TopologyConfig
from repro_torch.kernels import ota_aggregate as omod
from repro_torch.kernels.cwfl_round import cwfl_round
from repro_torch.kernels.ota_aggregate import ota_aggregate
from repro_torch.kernels.ref import cwfl_round_ref, ota_aggregate_ref
from repro_torch.models import small as tsmall
from repro_torch.sim import run_monte_carlo, run_rounds
from repro_torch.training import FLConfig
from test_torch_dist import _spawn
from test_torch_slice import JaxDraws

K, ROUNDS, NUM_TRAIN, EVAL = 8, 2, 1920, 256
# f32 sums in another order than XLA's (tests/test_torch_kernels.py).
F32_ATOL = 1e-5


# ---------------------------------------------------------------------------
# The kernels' trajectory axis.
# ---------------------------------------------------------------------------

def _round_inputs(B, K_, C, d):
    rng = np.random.default_rng(B + K_ + C + d)
    return (rng.standard_normal((B, K_, d)).astype(np.float32),
            rng.uniform(size=(B, C, K_)).astype(np.float32),
            (0.1 * rng.standard_normal((B, C, d))).astype(np.float32),
            rng.uniform(size=(B, C, C)).astype(np.float32),
            (0.1 * rng.standard_normal((B, C, d))).astype(np.float32),
            rng.uniform(size=(B, K_, C)).astype(np.float32))


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("B,K_,C,d", [(3, 8, 3, 1337), (2, 12, 4, 512)])
def test_batched_cwfl_round_matches_jax_vmap(B, K_, C, d, guard):
    """B rounds in one call, each with its own weights and noise, against
    ``jax.vmap`` of JAX's Pallas kernel (interpret mode) and of its
    oracle; guarded, with NaN and ±inf signals and a dead Ã row in one
    trajectory.  Each element equals the unbatched call on its inputs."""
    args = _round_inputs(B, K_, C, d)
    if guard:
        args[0][1, 2, 5] = np.nan
        args[0][0, 1, 7] = np.inf
        args[1][2 % B, 1] = 0.0
    jargs = [jnp.asarray(a) for a in args]
    refs = [jax.vmap(functools.partial(fn, guard=guard))(*jargs) for fn in
            (functools.partial(jax_cwfl_round, interpret=True),
             jax_cwfl_round_ref)]
    targs = [torch.from_numpy(a) for a in args]
    for fn in (cwfl_round_ref, cwfl_round):
        new, cons = fn(*targs, guard=guard)
        assert new.shape == (B, K_, d) and cons.shape == (B, d)
        for ref_new, ref_cons in refs:
            np.testing.assert_allclose(new.numpy(), np.asarray(ref_new),
                                       atol=F32_ATOL, rtol=0)
            np.testing.assert_allclose(cons.numpy(), np.asarray(ref_cons),
                                       atol=F32_ATOL, rtol=0)
        for b in range(B):
            one_new, one_cons = fn(*(x[b] for x in targs), guard=guard)
            np.testing.assert_allclose(new[b].numpy(), one_new.numpy(),
                                       atol=F32_ATOL, rtol=0)
            np.testing.assert_allclose(cons[b].numpy(), one_cons.numpy(),
                                       atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("B,K_,C,d", [(3, 8, 1, 700), (2, 50, 50, 257),
                                      (4, 12, 3, 1337)])
def test_batched_ota_aggregate_matches_jax_vmap(B, K_, C, d):
    """B products y_b = W_b·S_b + N_b in one call against ``jax.vmap`` of
    JAX's Pallas kernel (interpret mode, tile 256) and of its oracle: the
    COTAF sweep's one row, decentralized consensus's C = K rows."""
    rng = np.random.default_rng(B + C + d)
    s = rng.standard_normal((B, K_, d)).astype(np.float32)
    w = rng.uniform(size=(B, C, K_)).astype(np.float32)
    n = (0.1 * rng.standard_normal((B, C, d))).astype(np.float32)
    refs = [jax.vmap(functools.partial(jax_ota, tile=256, interpret=True))(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(n)),
        jax.vmap(jax_ota_ref)(jnp.asarray(s), jnp.asarray(w),
                              jnp.asarray(n))]
    ts, tw, tn = (torch.from_numpy(a) for a in (s, w, n))
    for fn in (ota_aggregate_ref, ota_aggregate):
        got = fn(ts, tw, tn)
        assert got.shape == (B, C, d)
        for ref in refs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=F32_ATOL, rtol=F32_ATOL)
        for b in range(B):
            np.testing.assert_allclose(got[b].numpy(),
                                       fn(ts[b], tw[b], tn[b]).numpy(),
                                       atol=F32_ATOL, rtol=0)


def test_batched_wrappers_check_shapes():
    s = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="weights must be"):
        ota_aggregate(s, torch.zeros(3, 1, 4), torch.zeros(2, 1, 16))
    with pytest.raises(ValueError, match="phase1 must be"):
        cwfl_round(s, torch.zeros(2, 3, 5), torch.zeros(2, 3, 16),
                   torch.zeros(2, 3, 3), torch.zeros(2, 3, 16),
                   torch.zeros(2, 4, 3))


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """The kernel's launch plan (``csrc/ota_plan.h``) built alone with the
    host's C++ compiler, as tests/test_torch_ota.py builds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan header with")
    d = tmp_path_factory.mktemp("ota_plan_batched")
    (d / "plan.cpp").write_text(f'#include "{omod.PLAN_HEADER}"\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", str(d / "plan.so"), str(d / "plan.cpp")],
                   check=True)
    return ctypes.CDLL(str(d / "plan.so"))


@pytest.mark.parametrize("K_,C", [(50, 1), (50, 3), (50, 50), (128, 128)])
def test_batched_launch_plan(plan_lib, K_, C):
    """One trajectory plans as before; B trajectories keep every block's
    plan (path, layout, tile) and only share out the grid: the column
    path's grid is a trajectory's tiles, the ring's persistent grid of
    resident blocks divided over the trajectories (rounded down: one
    wave), at least a block each; past 65,535 trajectories the plan
    refuses."""
    f32 = torch.float32
    one = omod.read_plan(plan_lib, K_, C, 184214, f32, f32, 132)
    for B in (1, 2, 8, 40, 300):
        p = omod.read_plan(plan_lib, K_, C, 184214, f32, f32, 132, batch=B)
        assert p.batch == B
        assert dataclasses.replace(p, grid=one.grid, batch=1) == one
        if not p.ring:
            assert p.grid == p.tiles
        else:
            share = max(one.blocks_per_sm * 132 // B, 1)
            assert p.grid == min(p.tiles, share)
            assert B > one.blocks_per_sm * 132 or p.grid * B <= 132 * \
                one.blocks_per_sm
    assert omod.read_plan(plan_lib, K_, C, 184214, f32, f32, 132,
                          batch=65536) is None


# ---------------------------------------------------------------------------
# run_monte_carlo.
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("strategy", ["cwfl", "cotaf"])
def test_run_monte_carlo_matches_jax(workload, strategy):
    """2 seeds x 2 SNRs with JAX's draws replayed seed by seed (a seed's
    SNR points share them, as JAX's inner vmap shares its keys): every
    element against JAX's vmapped sweep, loss within 1e-5 relative and
    accuracy within 2/eval_samples; the shapes and the seeds as JAX's."""
    topo, data = workload
    grid = [10.0, 30.0]
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jcfg = JaxFLConfig(strategy=strategy, rounds=ROUNDS, snr_db=40.0,
                       eval_samples=EVAL, seed=0)
    ref = jengine.run_monte_carlo(
        jinit, japply, lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
        topo, *(jnp.asarray(a) for a in data), jcfg, seeds=2,
        snr_grid=grid)
    n_k = data[0].shape[1]
    steps = n_k // jcfg.batch_size
    draws = [JaxDraws(jinit, dataclasses.replace(jcfg, seed=s), n_k, steps)
             for s in range(2)]
    cfg = FLConfig(strategy=strategy, rounds=ROUNDS, snr_db=40.0,
                   eval_samples=EVAL, seed=0)
    got = run_monte_carlo(*_port(workload), cfg, seeds=2, snr_grid=grid,
                          draws=draws, device="cpu")
    assert got["train_loss"].shape == (2, 2, ROUNDS)
    assert got["final_acc"].shape == (2, 2)
    np.testing.assert_array_equal(got["seeds"].numpy(),
                                  np.asarray(ref["seeds"]))
    np.testing.assert_array_equal(got["snr_grid"].numpy(),
                                  np.asarray(ref["snr_grid"]))
    np.testing.assert_allclose(got["train_loss"].numpy(),
                               np.asarray(ref["train_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"].numpy(),
                               np.asarray(ref["test_acc"]), atol=2 / EVAL)


@pytest.mark.parametrize("strategy", ["cwfl", "cotaf", "fedavg",
                                      "decentralized", "cwfl_prox",
                                      "cotaf_prox"])
def test_batched_elements_equal_lone_runs(workload, strategy):
    """Each trajectory of a 3-seed x 2-SNR sweep, bit for bit, the port's
    lone ``run_rounds`` with the same seed and SNR."""
    port = _port(workload)
    cfg = FLConfig(strategy=strategy, rounds=ROUNDS, snr_db=40.0,
                   eval_samples=EVAL, seed=5, lr=0.05)
    grid = [0.0, 20.0]
    h = run_monte_carlo(*port, cfg, seeds=3, snr_grid=grid, device="cpu")
    for s in range(3):
        for g, snr in enumerate(grid):
            one = run_rounds(*port, dataclasses.replace(
                cfg, seed=cfg.seed + s, snr_db=snr), device="cpu")
            assert torch.equal(h["train_loss"][s, g], one["train_loss"])
            assert torch.equal(h["test_acc"][s, g], one["test_acc"])


def test_monte_carlo_grid_and_guards(workload):
    """No grid: the seeds at ``cfg.snr_db``, (S, T); ``snr-sweep``'s own
    grid by default, (S, 5, T); a dynamic scenario, another shard and a
    wrong count of draws raise."""
    port = _port(workload)
    cfg = FLConfig(rounds=1, snr_db=40.0, eval_samples=EVAL, seed=0)
    seeds_only = run_monte_carlo(*port, cfg, seeds=2, device="cpu")
    assert seeds_only["train_loss"].shape == (2, 1)
    assert seeds_only["snr_grid"] is None
    assert seeds_only["seeds"].tolist() == [0, 1]
    sweep = run_monte_carlo(*port, cfg, scenario="snr-sweep", seeds=1,
                            device="cpu")
    assert sweep["train_loss"].shape == (1, 5, 1)
    assert sweep["snr_grid"].tolist() == [0.0, 10.0, 20.0, 30.0, 40.0]
    assert torch.equal(sweep["train_loss"][0, 4], seeds_only["train_loss"][0])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
        run_monte_carlo(*port, cfg, scenario="head-failure", seeds=1,
                        device="cpu")
    with pytest.raises(ValueError, match="shard='mc'"):
        run_monte_carlo(*port, cfg, seeds=1, shard="clients", device="cpu")
    with pytest.raises(ValueError, match="one Draws for each"):
        run_monte_carlo(*port, cfg, seeds=2, draws=[None], device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        run_monte_carlo(*port, cfg, seeds=1, shard="mc", device="cpu")


def _mc_job(rank, world, p):
    """This rank's part of the 3-seed x 3-SNR sweep (9 trajectories
    padded to 10: rank 0 runs seed 0 and two points of seed 1, rank 1 the
    rest and the padding)."""
    port = _port(p["workload"])
    h = run_monte_carlo(*port, p["cfg"], seeds=3, snr_grid=p["grid"],
                        shard="mc", device="cpu")
    return {k: h[k].numpy() for k in ("train_loss", "test_acc",
                                      "final_acc")}


def test_shard_mc_over_two_ranks_equals_unsharded(workload, tmp_path):
    cfg = FLConfig(rounds=ROUNDS, snr_db=40.0, eval_samples=EVAL, seed=2,
                   lr=0.05)
    grid = [0.0, 15.0, 30.0]
    ref = run_monte_carlo(*_port(workload), cfg, seeds=3, snr_grid=grid,
                          device="cpu")
    ranks = _spawn(_mc_job, 2, {"workload": workload, "cfg": cfg,
                                "grid": grid}, tmp_path)
    for got in ranks:
        for k in ("train_loss", "test_acc", "final_acc"):
            np.testing.assert_array_equal(got[k], ref[k].numpy())


@pytest.mark.parametrize("strategy", ["cwfl", "cotaf", "decentralized"])
def test_batched_strategy_hooks(workload, strategy):
    """``init_batch`` stacks one state a (seed, SNR) pair, a seed's first
    centre drawn once; ``sync_noise_batch`` is the per-seed hook
    stacked."""
    from repro_torch.sim import TorchDraws
    from repro_torch.strategies import get_strategy

    topo = _port(workload)[3]
    strat = get_strategy(strategy)
    cfg = FLConfig(strategy=strategy, num_clusters=3)
    pairs = [(0, 10.0), (0, 30.0), (1, 10.0)]
    stacked = strat.init_batch(topo, [TorchDraws(s, "cpu") for s in (0, 1)],
                               cfg, pairs)
    ones = [_leaves(strat.init(topo, TorchDraws(s, "cpu"), cfg, snr_db=snr))
            for s, snr in pairs]
    for x, ys in zip(_leaves(stacked), zip(*ones), strict=True):
        assert torch.equal(x, torch.stack(ys))
    draws = [TorchDraws(s, "cpu") for s in (0, 1)]
    noise = strat.sync_noise_batch(draws, 0, K, 3, 100)
    ones = [strat.sync_noise(TorchDraws(s, "cpu"), 0, K, 3, 100)
            for s in (0, 1)]
    for i, one in enumerate(ones):
        for x, y in zip(noise if isinstance(noise, tuple) else (noise,),
                        one if isinstance(one, tuple) else (one,)):
            assert torch.equal(x[i], y)


def _leaves(state):
    """A state's tensors, fields in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if dataclasses.is_dataclass(state):
        return [x for f in dataclasses.fields(state)
                for x in _leaves(getattr(state, f.name))]
    return []
