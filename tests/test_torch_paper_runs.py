"""The paper's experiments in the port (`repro_torch.paper`) against the
JAX package's: `run_federated` with the CIFAR CNN on a non-IID split, for
CWFL and COTAF-Prox, every JAX draw replayed through the port's seam (as
``tests/test_torch_slice.py`` does); Theorem 1's noiseless quadratic on
JAX's topology; the experiment grids of Table I and Fig. 2; and
``run_setting``'s history at a tiny scale."""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.training import FLConfig as JaxFLConfig
from repro.training import run_federated as jax_run_federated
from repro_torch.convert import topology_from_arrays
from repro_torch.core import cwfl as tcwfl
from repro_torch.core import topology as ttopo
from repro_torch.models import small as tsmall
from repro_torch.paper import common, convergence, fig2_accuracy, \
    table1_accuracy
from repro_torch.training import FLConfig, run_federated
from repro_torch.utils.pytree import tree_leaves
from test_torch_slice import JaxDraws

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the JAX package's benchmarks/
    sys.path.insert(0, str(ROOT))

K, C, ROUNDS, HW = 4, 3, 2, (8, 8, 3)
BATCH, SHARDS, SPC = 16, 40, 2          # 2 shards of 16: 2 steps a round
EVAL = 256


@pytest.fixture(scope="module")
def cnn_workload():
    dcfg = jdata.SyntheticImageConfig("cifar-like", *HW, 10, 640, EVAL)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_noniid(jax.random.PRNGKey(1), xtr, ytr, K, SPC,
                                    num_shards=SHARDS)
    tcfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.make_topology(jax.random.PRNGKey(7), tcfg)
    return topo, xs, ys, xte, yte


@pytest.mark.parametrize("strategy,mu", [("cwfl", 0.0), ("cotaf", 0.1)],
                         ids=["cwfl", "cotaf_prox"])
def test_cnn_noniid_run_matches_jax(cnn_workload, strategy, mu):
    topo, xs, ys, xte, yte = cnn_workload
    # the split is non-IID: each client holds at most its 2 shards' labels
    assert (jdata.label_histogram(ys, 10) > 0).sum(axis=1).max() <= 2 * SPC
    jinit, japply = jsmall.make_cifar_cnn(HW)
    jcfg = JaxFLConfig(strategy=strategy, rounds=ROUNDS, batch_size=BATCH,
                       mu_prox=mu, snr_db=40.0, eval_samples=EVAL, seed=0)
    ref = jax_run_federated(
        jinit, japply, lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
        topo, xs, ys, xte, yte, jcfg)

    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain),
                                ttopo.TopologyConfig(num_clients=K),
                                device="cpu")
    init, apply = tsmall.make_cifar_cnn(HW)
    cfg = FLConfig(strategy=strategy, rounds=ROUNDS, batch_size=BATCH,
                   mu_prox=mu, snr_db=40.0, eval_samples=EVAL, seed=0)
    n_k = xs.shape[1]
    steps = n_k // BATCH
    assert steps == 2
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    got = run_federated(init, apply,
                        lambda p, x, y: tsmall.nll_loss(apply(p, x), y),
                        ttop, *data, cfg,
                        draws=JaxDraws(jinit, jcfg, n_k, steps, num_clients=K),
                        device="cpu")

    assert got["round"] == ref["round"] == [1, 2]
    # f32 convolutions summed in another order than XLA's through 4 local
    # steps and 2 noisy syncs.
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["test_acc"], ref["test_acc"], rtol=0,
                               atol=2 / EVAL)
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree.leaves(ref["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_noiseless_quadratic_matches_jax():
    """Theorem 1's quadratic on JAX's topology, K-means start and client
    optima (``tests/test_convergence.py``'s ``_setup``, key 2), run
    noiseless for 60 rounds at η_t = 2/(γ+t): the per-round error to JAX's
    fixed point within rel 1e-5 (and abs 1e-7: the error falls to 1e-3,
    where a one-ulp difference in the f32 consensus already moves it by
    2e-5 of itself), and the port's own fixed point within abs 1e-5 of
    JAX's."""
    from test_convergence import (_setup, fixed_point,
                                  run_cwfl_quadratic)

    key, T = jax.random.PRNGKey(2), 60
    ref = run_cwfl_quadratic(T=T, snr_db=60.0, key=key, noiseless=True)
    topo, _, a = _setup(key)
    k_state = jax.random.split(key, 3)[1]
    first = int(jax.random.randint(k_state, (), 0, 12))
    ttop = topology_from_arrays(
        np.asarray(topo.positions), np.asarray(topo.link_gain),
        ttopo.TopologyConfig(num_clients=12, num_hotspots=3), device="cpu")
    state = tcwfl.setup(ttop, tcwfl.CWFLConfig(num_clusters=3, snr_db=60.0),
                        first)
    a = torch.from_numpy(np.array(a))
    star = torch.from_numpy(np.array(fixed_point(key)))
    got = convergence.run_quadratic(convergence._noiseless(state), a, T,
                                    star)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert got[-1] < got[30] / 2.0        # O(1/T) decay, as JAX's test
    np.testing.assert_allclose(convergence.fixed_point(state, a).numpy(),
                               star.numpy(), rtol=0, atol=1e-5)


def test_quadratic_noise_floor_orders_with_snr():
    """The port's own draws: at high SNR the error falls well below its
    start; the floor rises as the SNR falls (Q₂, Theorem 1)."""
    errs = convergence.run_cwfl_quadratic(T=60, snr_db=60.0, seed=2,
                                          device="cpu")
    assert errs[-1] < 0.1 * errs[0]
    out = convergence.run(T=60, device="cpu")
    assert out["snr10"]["floor"] > out["snr20"]["floor"] \
        > out["snr40"]["floor"]


def test_experiment_grids_equal_jax():
    from benchmarks import common as jcommon
    from benchmarks import fig2_accuracy as jfig2
    from benchmarks import table1_accuracy as jtable1

    assert table1_accuracy.ROWS == jtable1.ROWS
    assert fig2_accuracy.SETTINGS == jfig2.SETTINGS
    for scale in ("__init__", "full"):
        j = (jcommon.BenchScale() if scale == "__init__"
             else jcommon.BenchScale.full())
        t = (common.BenchScale() if scale == "__init__"
             else common.BenchScale.full())
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


TINY = common.BenchScale(mnist_clients=4, cifar_clients=3, mnist_train=640,
                         cifar_train=480, test=64, rounds=2,
                         eval_samples=64)


@pytest.fixture(scope="module")
def jax_history():
    """JAX's ``run_setting`` history at the tiny scale (MNIST CWFL-4)."""
    from benchmarks import common as jcommon

    return jcommon.run_setting(
        "mnist", False, "cwfl", jcommon.BenchScale(**dataclasses.asdict(TINY)),
        num_clusters=4)


@pytest.mark.parametrize("name,iid,strategy,C,mu", [
    ("mnist", False, "cwfl", 4, 0.0), ("cifar", False, "cotaf", 3, 0.1),
    ("cifar", True, "cwfl", 3, 0.0)], ids=["mnist_cwfl4", "cifar_cotaf_prox",
                                           "cifar_iid_cwfl"])
def test_run_setting_returns_jax_history_keys(jax_history, name, iid,
                                              strategy, C, mu):
    """At a tiny scale on the CPU: the keys of JAX's history, a value a
    round, and the dataset's model (its params shaped as JAX's init)."""
    got = common.run_setting(name, iid, strategy, TINY, num_clusters=C,
                             mu_prox=mu, device="cpu")
    assert set(got) == set(jax_history)
    assert got["round"] == jax_history["round"] == [1, 2]
    assert len(got["test_acc"]) == len(got["train_loss"]) == 2
    assert all(np.isfinite(got["train_loss"]))
    jinit = (jsmall.make_mnist_mlp()[0] if name == "mnist"
             else jsmall.make_cifar_cnn()[0])
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in tree_leaves(got["final_params"])] == \
        [x.shape for x in jax.tree.leaves(shapes)]


def test_table1_skips_cwfl4_on_cifar_and_writes_where_told(tmp_path,
                                                            monkeypatch):
    seen = []

    def fake(ds, iid, strat, scale, num_clusters, mu_prox, device):
        seen.append((ds, iid, strat, num_clusters, mu_prox, device))
        return {"avg_acc": 0.5}

    monkeypatch.setattr(table1_accuracy, "run_setting", fake)
    out = tmp_path / "t1.json"
    table = table1_accuracy.run(common.BenchScale(), out_path=out,
                                device="cpu")
    assert table["cifar"]["CWFL-4"] is None
    assert len(seen) == 9 and all(not iid for _, iid, *_ in seen)
    assert ("cifar", False, "cotaf", 3, 0.1, "cpu") in seen
    assert out.exists()
    table1_accuracy.run(common.BenchScale(), datasets=("mnist",))
    assert not (tmp_path / "results").exists()


def test_paper_fig2_example_runs_on_the_cpu(monkeypatch):
    """``examples/paper_fig2_torch.py --fast --device cpu`` runs the first
    four curves of SETTINGS on the CPU (shrunk here to the tiny scale)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "paper_fig2_torch", ROOT / "examples" / "paper_fig2_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(example, "BenchScale", lambda: TINY)
    rows = example.main(["--fast", "--device", "cpu"])
    assert [(r["dataset"], r["iid"], r["label"]) for r in rows] == [
        (ds, iid, label) for ds, iid, _, _, _, label in
        fig2_accuracy.SETTINGS[:4]]
    assert all(len(r["acc_curve"]) == TINY.rounds for r in rows)


def test_paper_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.run_setting("mnist", True, "cwfl", TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        convergence.run(T=5)
