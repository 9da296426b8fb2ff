"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``'s
computation in the JAX package: the JAX quickstart's own topology
(``PRNGKey(0)``, K=16 around 3 hotspots), its offline plan (K-means'
first centre from ``PRNGKey(0)``), its data (keys 1 and 2, the training
set cut from 6,000 to 3,072 examples so that a client holds 192, three
steps of 64) and JAX's draws replayed, at 3 of its 12 rounds.  Both of
its runs, ``cwfl`` and ``fedavg``, are held to JAX's ``run_federated``
within the slice's tolerances, and what it prints of the plan and the
channel uses to what the JAX script prints."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro.core.cwfl import channel_uses_per_round
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.training import FLConfig as JaxFLConfig
from repro.training import run_federated as jax_run_federated
from repro_torch.convert import topology_from_arrays
from repro_torch.core import topology as ttopo
from repro_torch.utils.pytree import tree_leaves
from test_torch_slice import JaxDraws

K, C, ROUNDS, NUM_TRAIN, NUM_TEST, EVAL = 16, 3, 3, 3072, 1500, 1024
ROOT = Path(__file__).resolve().parents[1]


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def both():
    key = jax.random.PRNGKey(0)
    tcfg = jtopo.TopologyConfig(num_clients=K, num_hotspots=3)
    topo = jtopo.make_topology(key, tcfg)
    plan = jcl.make_cluster_plan(topo.link_snr, topo.adjacency, C, key)
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=NUM_TRAIN,
                                                 num_test=NUM_TEST)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(1), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(2), xtr, ytr, K)
    init, apply = jsmall.make_mnist_mlp()
    cfgs = {s: JaxFLConfig(strategy=s, rounds=ROUNDS, num_clusters=C,
                           snr_db=40.0, eval_samples=EVAL)
            for s in ("cwfl", "fedavg")}
    refs = {s: jax_run_federated(
        init, apply, lambda p, x, y: jsmall.nll_loss(apply(p, x), y),
        topo, xs, ys, xte, yte, cfg) for s, cfg in cfgs.items()}

    ttop = topology_from_arrays(
        np.asarray(topo.positions), np.asarray(topo.link_gain),
        ttopo.TopologyConfig(num_clients=K, num_hotspots=3), device="cpu")
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    n_k = xs.shape[1]
    steps = n_k // 64
    assert steps == 3
    draws = JaxDraws(init, cfgs["cwfl"], n_k, steps, num_clients=K)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = _quickstart().run(
            ttop, data, rounds=ROUNDS, eval_samples=EVAL, device="cpu",
            first=int(jax.random.randint(key, (), 0, K)),
            draws=lambda: draws)
    return plan, refs, got, out.getvalue().splitlines()


def test_quickstart_prints_what_the_jax_script_prints(both):
    """The JAX script's lines: its plan and the channel uses exactly, then
    a line a round and the final accuracy of each run."""
    plan, _, got, out = both
    uses = channel_uses_per_round(K, C)
    assert out[0] == "== topology & SNR clustering (offline phase) =="
    assert out[1:5] == [
        f"clients: {K}, clusters: {plan.assignment.tolist()}",
        f"cluster heads: {plan.heads.tolist()}",
        f"cluster SNRs (dB): "
        f"{[round(float(10 * np.log10(x)), 1) for x in plan.cluster_snr]}",
        f"channel uses/round: CWFL={uses['cwfl']} vs "
        f"decentralized={uses['decentralized']} "
        f"({uses['decentralized'] / uses['cwfl']:.0f}x saving)"]
    for strategy in ("cwfl", "fedavg"):
        i = out.index(f"== {strategy} ==")
        h = got["histories"][strategy]
        assert out[i + 1:i + 5] == [
            *(f"  round {r:2d}  loss={l:.3f}  acc={a:.3f}" for r, l, a in
              zip(h["round"], h["train_loss"], h["test_acc"])),
            f"  final accuracy: {h['final_acc']:.3f}"]
    assert got["plan"].assignment.tolist() == plan.assignment.tolist()
    assert got["plan"].heads.tolist() == plan.heads.tolist()
    np.testing.assert_allclose(got["plan"].cluster_snr.numpy(),
                               np.asarray(plan.cluster_snr), rtol=1e-5)
    assert got["channel_uses"] == channel_uses_per_round(K, C)
    assert (got["channel_uses"]["cwfl"],
            got["channel_uses"]["decentralized"]) == (9, 240)


@pytest.mark.parametrize("strategy", ["cwfl", "fedavg"])
def test_quickstart_runs_match_jax(both, strategy):
    _, refs, got, _ = both
    h, ref = got["histories"][strategy], refs[strategy]
    assert h["round"] == ref["round"] == [1, 2, 3]
    np.testing.assert_allclose(h["train_loss"], ref["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(h["test_acc"], ref["test_acc"], rtol=0,
                               atol=2 / EVAL)
    for a, b in zip(tree_leaves(h["final_params"]),
                    jax.tree.leaves(ref["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
