"""The port's whole slice — `run_federated` with CWFL on the static
scenario — against the JAX package's `run_federated`, run live on the
protocol of ``tests/goldens/paper_static_T4_K8.json`` (K=8, hidden=32,
C=3, 40 dB), at 3 rounds of 3 local steps.

Every JAX draw is rebuilt from the engine's key chain and handed to the
port through its draw seam: ``prepare`` splits (state, init, rounds)
(`repro/sim/engine.py`), K-means' first pick is ``randint(k_state)``
(`repro/core/clustering.py`), each round splits (local, aggregation), the
minibatch indices are ``randint`` per client and step
(`repro/training/local.py`), and the aggregation key splits into the
phase-1 and phase-2 noise (`repro/core/cwfl.py`); a baseline's sync
draws its one noise matrix from the aggregation key itself, leaf by leaf
(`repro/core/baselines.py`, ``_mix_rows``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cwfl as jcwfl
from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.training import FLConfig as JaxFLConfig
from repro.training import run_federated as jax_run_federated
from repro_torch.convert import params_from_jax, topology_from_arrays
from repro_torch.core import topology as ttopo
from repro_torch.models import small as tsmall
from repro_torch.training import FLConfig, run_federated
from repro_torch.utils.pytree import tree_leaves

K, C, ROUNDS, NUM_TRAIN, EVAL = 8, 3, 3, 1920, 256


class JaxDraws:
    """The JAX engine's draws for one run, replayed through the seam."""

    def __init__(self, init_fn, cfg, n_k, steps, num_clients=K):
        k_state, k_init, k_rounds = jax.random.split(
            jax.random.PRNGKey(cfg.seed), 3)
        K, C = num_clients, cfg.num_clusters
        self.first = int(jax.random.randint(k_state, (), 0, K))
        self.params = jax.tree.map(np.asarray, init_fn(k_init))
        leaves = [np.broadcast_to(x, (K,) + x.shape)
                  for x in jax.tree.leaves(self.params)]
        ones = jnp.ones((C,), jnp.float32)
        self.leaves = leaves
        self.idx, self.noise, self.k_agg = [], [], []
        for rkey in jax.random.split(k_rounds, cfg.rounds):
            k_local, k_agg = jax.random.split(rkey)
            self.k_agg.append(k_agg)
            self.idx.append(np.stack([np.stack([
                np.asarray(jax.random.randint(k, (cfg.batch_size,), 0, n_k))
                for k in jax.random.split(ck, steps)])
                for ck in jax.random.split(k_local, K)]))
            self.noise.append(tuple(
                np.asarray(jcwfl._flat_leaf_noise(k, leaves, C, ones))
                for k in jax.random.split(k_agg)))

    def kmeans_first(self, num_clients):
        return torch.tensor(self.first)

    def init_params(self, init_fn):
        return params_from_jax(self.params, device="cpu")

    def batch_indices(self, round_, num_clients, steps, batch, n_k):
        return torch.from_numpy(np.array(self.idx[round_]))

    def phase_noise(self, round_, num_clusters, d):
        return tuple(torch.from_numpy(np.array(x)) for x in self.noise[round_])

    def sync_noise(self, round_, rows, d):
        return torch.from_numpy(np.array(jcwfl._flat_leaf_noise(
            self.k_agg[round_], self.leaves, rows,
            jnp.ones((rows,), jnp.float32))))

    def state(self):
        return {}     # indexed by round: nothing to restore

    def set_state(self, state):
        del state


@pytest.fixture(scope="module")
def workload():
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=NUM_TRAIN,
                                                 num_test=EVAL)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(1), xtr, ytr, K)
    topo = jtopo.make_topology(jax.random.PRNGKey(7),
                               jtopo.TopologyConfig(num_clients=K))
    return topo, xs, ys, xte, yte


def _torch_side(workload):
    topo, xs, ys, xte, yte = workload
    ttop = topology_from_arrays(np.asarray(topo.positions),
                                np.asarray(topo.link_gain),
                                ttopo.TopologyConfig(num_clients=K),
                                device="cpu")
    data = tuple(torch.from_numpy(np.array(a)) for a in (xs, ys, xte, yte))
    init, apply = tsmall.make_mnist_mlp(hidden=(32,))
    loss = lambda p, x, y: tsmall.nll_loss(apply(p, x), y)   # noqa: E731
    return init, apply, loss, ttop, data


def test_run_federated_matches_jax(workload):
    topo, xs, ys, xte, yte = workload
    jcfg = JaxFLConfig(rounds=ROUNDS, snr_db=40.0, eval_samples=EVAL, seed=0)
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    ref = jax_run_federated(
        jinit, japply, lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
        topo, xs, ys, xte, yte, jcfg)

    init, apply, loss, ttop, data = _torch_side(workload)
    cfg = FLConfig(rounds=ROUNDS, snr_db=40.0, eval_samples=EVAL, seed=0)
    n_k = xs.shape[1]
    steps = n_k // cfg.batch_size
    assert steps == 3
    got = run_federated(init, apply, loss, ttop, *data, cfg,
                        draws=JaxDraws(jinit, jcfg, n_k, steps),
                        device="cpu")

    assert got["round"] == ref["round"] == [1, 2, 3]
    # f32 sums in another order than XLA's through 9 SGD steps and 3
    # noisy rounds: per-round loss within 1e-4 relative.
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               rtol=1e-4)
    # A logit near a tie may flip one or two of the eval examples.
    np.testing.assert_allclose(got["test_acc"], ref["test_acc"], rtol=0,
                               atol=2 / EVAL)
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree.leaves(ref["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_run_federated_default_draws_learn(workload):
    """Without the seam the port draws for itself, from ``cfg.seed``."""
    init, apply, loss, ttop, data = _torch_side(workload)
    cfg = FLConfig(rounds=3, snr_db=40.0, eval_samples=EVAL, seed=0,
                   lr=0.05)
    a = run_federated(init, apply, loss, ttop, *data, cfg, device="cpu")
    b = run_federated(init, apply, loss, ttop, *data, cfg, device="cpu")
    assert a["train_loss"] == b["train_loss"]
    assert np.all(np.isfinite(a["train_loss"]))
    assert a["train_loss"][-1] < a["train_loss"][0]


def test_run_federated_needs_a_card_unless_told_cpu(workload):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    init, apply, loss, ttop, data = _torch_side(workload)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(init, apply, loss, ttop, *data,
                      FLConfig(rounds=1, eval_samples=EVAL))


def test_run_federated_rejects_unported_scenarios(workload):
    """Every registered scenario and strategy is ported: the call that
    once raised ``NotImplementedError`` — FedProx (``mu_prox=0.1``, what
    ``straggler-prox``'s ``cwfl_prox`` sets) under ``straggler-prox`` with
    ``cfg.strategy`` ``cwfl`` — now runs, warns as JAX warns, and matches
    JAX's run on JAX's draws."""
    from repro.sim.scenarios import get_scenario as jax_get_scenario
    from test_torch_scenarios import JaxScenarioDraws

    topo, xs, ys, xte, yte = workload
    jcfg = JaxFLConfig(rounds=1, snr_db=40.0, eval_samples=EVAL, seed=0,
                       mu_prox=0.1)
    jinit, japply = jsmall.make_mnist_mlp(hidden=(32,))
    jscen = jax_get_scenario("straggler-prox")
    with pytest.warns(UserWarning, match="cwfl_prox"):
        ref = jax_run_federated(
            jinit, japply, lambda p, x, y: jsmall.nll_loss(japply(p, x), y),
            topo, xs, ys, xte, yte, jcfg, scenario=jscen)
    init, apply, loss, ttop, data = _torch_side(workload)
    n_k = xs.shape[1]
    with pytest.warns(UserWarning, match="cwfl_prox"):
        got = run_federated(
            init, apply, loss, ttop, *data,
            FLConfig(rounds=1, eval_samples=EVAL, mu_prox=0.1),
            scenario="straggler-prox", device="cpu",
            draws=JaxScenarioDraws(jinit, jcfg, n_k, n_k // 64, jscen))
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["test_acc"], ref["test_acc"], rtol=0,
                               atol=2 / EVAL)
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree.leaves(ref["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    assert min(got["scenario"]["mask_mass"]) < K


def test_run_federated_turns_tf32_off_for_the_run_only(workload):
    """The run computes in full f32, as the reference does; the caller's
    TF32 flags are back when it returns."""
    init, apply, loss, ttop, data = _torch_side(workload)
    seen = []
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        run_federated(init, apply, loss, ttop, *data,
                      FLConfig(rounds=1, eval_samples=EVAL),
                      progress=lambda *_: seen.append(
                          (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)),
                      device="cpu")
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
