"""FedProx in the port — `training.local.fedprox_wrap`, the prox local
runner, and the paper's CWFL-Prox and COTAF-Prox runs — against the JAX
package's, on the same numpy inputs and JAX's draws replayed.

The proximal term is each client's own: (µ_p/2)·‖θ_k − θ_k^0‖², summed
over every leaf, anchored at the client's params at the start of the
round.  The port trains the K clients together through one backward pass
over the sum of their losses, so each client's gradient is its own (a
mean over K would scale it by 1/K)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import small as jsmall
from repro.optim import sgd as jsgd
from repro.training import local as jlocal
from repro_torch.convert import params_from_jax
from repro_torch.models import small as tsmall
from repro_torch.optim import sgd
from repro_torch.training import local as tlocal
from repro_torch.utils.pytree import tree_leaves
from test_torch_baseline_runs import assert_strategy_run
from test_torch_scenarios import workload  # noqa: F401  (a fixture)

K, N_K, BATCH, STEPS = 4, 96, 16, 5


def _client_params(seed):
    """K different parameter sets of the hidden-32 MNIST MLP, numpy."""
    init, _ = jsmall.make_mnist_mlp(hidden=(32,))
    return jax.tree.map(np.asarray, jax.vmap(init)(
        jax.random.split(jax.random.PRNGKey(seed), K)))


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, N_K, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (K, N_K)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("mu", [0.1, 1.0])
def test_fedprox_wrap_matches_jax(mu):
    """The wrapped loss at params away from the anchor, and its gradient:
    µ(θ_k − θ_g) on top of each client's own loss gradient."""
    _, japply = jsmall.make_mnist_mlp(hidden=(32,))
    _, tapply = tsmall.make_mnist_mlp(hidden=(32,))
    params, anchor = _client_params(0), _client_params(1)
    x, y = _data(2)
    jloss = jlocal.fedprox_wrap(
        lambda p, x, y: jsmall.nll_loss(japply(p, x), y), mu)
    ref, ref_grad = jax.vmap(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        jax.tree.map(jnp.asarray, anchor))
    tloss = tlocal.fedprox_wrap(
        lambda p, x, y: tsmall.nll_loss(tapply(p, x), y), mu)
    p = params_from_jax(params, device="cpu")
    leaves = [v.requires_grad_(True) for v in tree_leaves(p)]
    got = tloss(p, torch.from_numpy(x), torch.from_numpy(y).long(),
                params_from_jax(anchor, device="cpu"))
    grads = torch.autograd.grad(got.sum(), leaves)
    assert tuple(got.shape) == (K,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5)
    for g, r in zip(grads, jax.tree.leaves(ref_grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("mu", [0.0, 0.1, 2.0])
def test_prox_local_runner_matches_jax(mu):
    """Five SGD steps per client from different starting params, JAX's
    minibatches replayed: the params and the reported loss (the proximal
    term included, as JAX's ``value_and_grad(prox_loss)`` returns it)."""
    _, japply = jsmall.make_mnist_mlp(hidden=(32,))
    _, tapply = tsmall.make_mnist_mlp(hidden=(32,))
    params = _client_params(3)
    x, y = _data(4)
    keys = jax.random.split(jax.random.PRNGKey(5), K)
    jopt = jsgd(0.5)
    jrun = jlocal.make_local_runner(
        lambda p, x, y: jsmall.nll_loss(japply(p, x), y), jopt, BATCH,
        STEPS, mu)
    jp = jax.tree.map(jnp.asarray, params)
    ref_p, _, ref_loss = jax.vmap(jrun)(jp, jax.vmap(jopt.init)(jp),
                                        jnp.asarray(x), jnp.asarray(y), keys)
    idx = np.stack([np.stack([
        np.asarray(jax.random.randint(k, (BATCH,), 0, N_K))
        for k in jax.random.split(ck, STEPS)]) for ck in keys])

    opt = sgd(0.5)
    trun = tlocal.make_local_runner(
        lambda p, x, y: tsmall.nll_loss(tapply(p, x), y), opt, BATCH,
        STEPS, mu_prox=mu)
    tp = params_from_jax(params, device="cpu")
    got_p, _, got_loss = trun(tp, opt.init(tp), torch.from_numpy(x),
                              torch.from_numpy(y).long(),
                              torch.from_numpy(idx))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(ref_loss),
                               rtol=1e-5)
    for g, r in zip(tree_leaves(got_p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


# The paper's CWFL-Prox and COTAF-Prox (µ_p = 0.1 from the registry):
# static, under straggler-prox (which pins cwfl_prox) and, for COTAF-Prox,
# mobile-fading (its server and water-filling rebuilt from the moving
# channel every round, with imperfect CSI).
@pytest.mark.parametrize("strategy,scenario", [
    ("cwfl_prox", "paper-static"), ("cwfl_prox", "straggler-prox"),
    ("cotaf_prox", "paper-static"), ("cotaf_prox", "mobile-fading")])
def test_prox_run_matches_jax(workload, strategy, scenario):  # noqa: F811
    assert_strategy_run(workload, strategy, scenario)
