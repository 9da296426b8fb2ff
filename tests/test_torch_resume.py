"""Checkpoint and resume of the port's runs (`repro_torch.sim.engine.
run_rounds(checkpoint_dir=, resume=, stop_after=)`), the counterparts of
``tests/test_faults.py``'s resume tests: a run stopped at a segment
boundary and resumed gives, bit for bit, the uninterrupted run's history,
telemetry and final params — for each strategy, from every boundary,
under live faults, with the port's own draws (their generators restored)
and with JAX's replayed ones, and client-sharded over two ``gloo``
ranks.  The manifest refuses a changed config, and the argument checks
are JAX's.  Small sizes: K=8, hidden 32, 4 rounds on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import small as jsmall
from repro.training import FLConfig as JaxFLConfig
from repro_torch.core import TopologyConfig, make_topology
from repro_torch.data import (SyntheticImageConfig, make_synthetic_images,
                              partition_iid)
from repro_torch.models import make_mnist_mlp, nll_loss
from repro_torch.obs import PhaseTimers
from repro_torch.sim import TorchDraws, run_rounds
from repro_torch.training import FLConfig
from repro_torch.utils.nest import nest_tensors
from test_torch_dist import _spawn
from test_torch_slice import JaxDraws

K, EVAL = 8, 256
TCFG = TopologyConfig(num_clients=K)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    init, apply = make_mnist_mlp(hidden=(32,))
    return init, apply, lambda p, x, y: nll_loss(apply(p, x), y)


@pytest.fixture(scope="module")
def data():
    """The topology and the data (picklable, for the spawned ranks)."""
    topo = make_topology(7, TCFG, device="cpu")
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        0, SyntheticImageConfig.mnist_like(1920, EVAL), device="cpu")
    xs, ys = partition_iid(1, xtr, ytr, K)
    return topo, xs, ys, xte, yte


@pytest.fixture(scope="module")
def wl(data):
    return (*_model(), *data)


def _hist(wl, strategy="cwfl", scenario=None, rounds=4, **kw):
    cfg = FLConfig(strategy=strategy, rounds=rounds, snr_db=40.0,
                   eval_samples=EVAL, seed=0)
    return run_rounds(*wl, cfg, scenario=scenario, topo_cfg=TCFG,
                      device="cpu", **kw)


def assert_same_run(got: dict, want: dict) -> None:
    """Bit for bit: the metrics, the scenario records, the telemetry and
    the final params."""
    assert got["round"].tolist() == want["round"].tolist()
    for key in ("train_loss", "test_acc"):
        assert torch.equal(got[key], want[key]), key
    for a, b in zip(nest_tensors(got["final_params"]),
                    nest_tensors(want["final_params"])):
        assert torch.equal(a, b)
    assert sorted(got.get("scenario", {})) == sorted(want.get("scenario", {}))
    for k, v in want.get("scenario", {}).items():
        assert torch.equal(got["scenario"][k], v), k
    if "telemetry" in want:
        assert sorted(got["telemetry"].extras) == sorted(
            want["telemetry"].extras)
        for a, b in zip(nest_tensors(got["telemetry"]),
                        nest_tensors(want["telemetry"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("strategy", ["cwfl", "cotaf", "fedavg",
                                      "decentralized", "cwfl_prox",
                                      "cotaf_prox"])
def test_resume_is_bitwise(wl, strategy, tmp_path):
    """Stopped after round 2 of 4 (a checkpoint every round), resumed: the
    history, the telemetry and the final params are the uninterrupted
    run's, bit for bit."""
    full = _hist(wl, strategy, telemetry=True)
    part = _hist(wl, strategy, telemetry=True, checkpoint_dir=tmp_path,
                 checkpoint_every=1, stop_after=2)
    assert part["train_loss"].shape == (2,)
    assert [s for s, _ in part["checkpoint"]["saves"]] == [1, 2]
    res = _hist(wl, strategy, telemetry=True, checkpoint_dir=tmp_path,
                checkpoint_every=1, resume=True)
    assert res["checkpoint"]["resumed_from"] == 2
    assert_same_run(res, full)


@pytest.mark.parametrize("stop", [1, 3, 4])
def test_resume_from_every_boundary(wl, stop, tmp_path):
    """From each boundary, the last (nothing left to run) included."""
    full = _hist(wl)
    _hist(wl, checkpoint_dir=tmp_path, checkpoint_every=1, stop_after=stop)
    res = _hist(wl, checkpoint_dir=tmp_path, checkpoint_every=1, resume=True)
    assert_same_run(res, full)
    again = _hist(wl, checkpoint_dir=tmp_path, checkpoint_every=1,
                  resume=True, resume_step=1)
    assert_same_run(again, full)


@pytest.mark.parametrize("scenario", ["flaky-clients", "head-failure",
                                      "cluster-churn"])
def test_resume_with_live_faults(wl, scenario, tmp_path):
    """The fault chains, the channel process and the cluster plan ride
    the checkpointed carry, the scenario generator its draws' state: the
    resumed run continues the same sample path."""
    full = _hist(wl, scenario=scenario, rounds=6, telemetry=True)
    _hist(wl, scenario=scenario, rounds=6, telemetry=True,
          checkpoint_dir=tmp_path, checkpoint_every=2, stop_after=3)
    res = _hist(wl, scenario=scenario, rounds=6, telemetry=True,
                checkpoint_dir=tmp_path, checkpoint_every=2, resume=True)
    assert res["checkpoint"]["resumed_from"] == 4
    assert_same_run(res, full)


def test_resume_with_jax_draws(wl, tmp_path):
    """Draws indexed by round (JAX's replayed keys) have no state to
    restore, and resume as well."""
    init, *_, xs = wl[:5]
    jinit, _ = jsmall.make_mnist_mlp(hidden=(32,))
    jcfg = JaxFLConfig(rounds=4, snr_db=40.0, eval_samples=EVAL, seed=0)
    n_k = xs.shape[1]

    def draws():
        return JaxDraws(jinit, jcfg, n_k, n_k // jcfg.batch_size)

    full = _hist(wl, draws=draws())
    _hist(wl, draws=draws(), checkpoint_dir=tmp_path, checkpoint_every=2,
          stop_after=2)
    res = _hist(wl, draws=draws(), checkpoint_dir=tmp_path,
                checkpoint_every=2, resume=True)
    assert_same_run(res, full)


def test_torch_draws_state_round_trips():
    a, b = TorchDraws(3, "cpu"), TorchDraws(3, "cpu")
    a.batch_indices(0, K, 3, 64, 240)
    a.fault_uniforms(0, K)
    b.set_state(a.state())
    assert torch.equal(a.batch_indices(1, K, 3, 64, 240),
                       b.batch_indices(1, K, 3, 64, 240))
    assert torch.equal(a.csi_normals(1, K), b.csi_normals(1, K))


def test_the_manifest_refuses_another_config(wl, tmp_path):
    _hist(wl, checkpoint_dir=tmp_path, checkpoint_every=1, stop_after=1)
    assert (tmp_path / "manifest.json").exists()
    with pytest.raises(ValueError, match="manifest"):
        _hist(wl, scenario="head-failure", checkpoint_dir=tmp_path,
              checkpoint_every=1, resume=True)
    with pytest.raises(ValueError, match="manifest"):
        _hist(wl, strategy="cotaf", checkpoint_dir=tmp_path, resume=True)
    with pytest.raises(FileNotFoundError):
        _hist(wl, checkpoint_dir=tmp_path / "nowhere", resume=True)
    with pytest.raises(ValueError, match="round range"):
        _hist(wl, checkpoint_dir=tmp_path, resume=True, resume_step=9)


def test_argument_checks(wl, tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _hist(wl, resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _hist(wl, stop_after=2)
    with pytest.raises(ValueError, match="loop"):
        _hist(wl, checkpoint_dir=tmp_path, mode="loop")
    with pytest.raises(ValueError, match="timers"):
        _hist(wl, checkpoint_dir=tmp_path, timers=PhaseTimers())

    @dataclasses.dataclass
    class Stateless:
        inner: JaxDraws

        def __getattr__(self, name):
            if name in ("state", "set_state"):
                raise AttributeError(name)
            return getattr(self.inner, name)

    jinit, _ = jsmall.make_mnist_mlp(hidden=(32,))
    jcfg = JaxFLConfig(rounds=4, snr_db=40.0, eval_samples=EVAL, seed=0)
    n_k = wl[4].shape[1]
    draws = Stateless(JaxDraws(jinit, jcfg, n_k, n_k // jcfg.batch_size))
    _hist(wl, draws=draws)                    # no checkpoint: no state needed
    with pytest.raises(TypeError, match="state"):
        _hist(wl, draws=draws, checkpoint_dir=tmp_path / "s")


def _sharded_resume_job(rank, world, p):
    """One rank of the client-sharded run: uninterrupted, stopped after
    round 2, resumed (its own TorchDraws, telemetry on)."""
    import repro_torch.sim as sim

    wl = (*_model(), *p["data"])
    cfg = FLConfig(rounds=4, snr_db=40.0, eval_samples=EVAL, seed=0)
    kw = dict(device="cpu", shard="clients", telemetry=True)
    full = sim.run_rounds(*wl, cfg, **kw)
    part = sim.run_rounds(*wl, cfg, checkpoint_dir=p["dir"],
                          checkpoint_every=1, stop_after=2, **kw)
    res = sim.run_rounds(*wl, cfg, checkpoint_dir=p["dir"],
                         checkpoint_every=1, resume=True, **kw)
    return {"full": full, "part_rounds": part["train_loss"].shape[0],
            "res": res}


def test_client_sharded_resume_over_two_ranks(data, tmp_path):
    """Two gloo ranks of four clients: rank 0 writes the whole carry,
    every rank loads it and keeps its rows; the resumed run is the
    uninterrupted sharded run, bit for bit, on both ranks."""
    ranks = _spawn(_sharded_resume_job, 2,
                   {"data": data, "dir": str(tmp_path / "ckpt")}, tmp_path)
    for got in ranks:
        assert got["part_rounds"] == 2
        assert_same_run(got["res"], got["full"])
        assert_same_run(got["res"], ranks[0]["res"])
    manifest = (tmp_path / "ckpt" / "manifest.json").read_text()
    assert '"strategy": "cwfl@clients"' in manifest
    saved = np.load(tmp_path / "ckpt" / "step_00000004" / "arrays.npz")
    assert saved["carry/stacked/fc0/w"].shape[0] == K
