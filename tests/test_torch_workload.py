"""The port's workload (synthetic data, MNIST MLP, SGD local training)
against the JAX package on identical inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.optim import sgd as jsgd
from repro.training.local import make_local_runner as jax_local_runner
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as tdata
from repro_torch.models import small as tsmall
from repro_torch.optim import sgd
from repro_torch.training.local import make_local_runner
from repro_torch.utils.pytree import tree_leaves

# f32 matmuls and reductions in another order than XLA's.
ATOL = 1e-5


def _mlp_params(K=None, seed=0, hidden=(32, 16)):
    init, _ = jsmall.make_mnist_mlp(hidden=hidden)
    params = init(jax.random.PRNGKey(seed))
    if K is not None:   # K distinct clients
        params = jax.tree.map(
            lambda x: x[None] + 0.01 * jax.random.normal(
                jax.random.PRNGKey(seed + 1), (K,) + x.shape), params)
    return jax.tree.map(np.asarray, params)


def test_prototypes_match_jax_resize():
    """Bilinear 4x4 -> 28x28 upsampling: ``jax.image.resize`` against
    ``F.interpolate(align_corners=False)`` agree within 5.1e-7 abs.  The
    unit-std scaling then differs by 2.2e-6 relative: ``jnp.std`` over the
    7,840 values sums in f32 and lands that far from the exact std, which
    ``torch.std`` hits within 3e-8."""
    cfg = jdata.SyntheticImageConfig.mnist_like()
    key = jax.random.PRNGKey(4)
    low = jax.random.normal(key, (cfg.num_classes, cfg.smoothness,
                                  cfg.smoothness, cfg.channels))
    ref = np.asarray(jdata._prototypes(key, cfg))
    got = tdata._prototypes(torch.from_numpy(np.array(low)),
                            tdata.SyntheticImageConfig.mnist_like())
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=5e-6)


def test_synthetic_images_and_iid_partition():
    cfg = tdata.SyntheticImageConfig.mnist_like(num_train=960, num_test=100)
    (xtr, ytr), (xte, yte) = tdata.make_synthetic_images(0, cfg,
                                                         device="cpu")
    assert xtr.shape == (960, 28, 28, 1) and xtr.dtype == torch.float32
    assert xte.shape == (100, 28, 28, 1) and yte.shape == (100,)
    assert int(ytr.min()) >= 0 and int(ytr.max()) < 10
    (xtr2, _), _ = tdata.make_synthetic_images(0, cfg, device="cpu")
    assert torch.equal(xtr, xtr2)
    xs, ys = tdata.partition_iid(1, xtr, ytr, 7)
    assert xs.shape == (7, 137, 28, 28, 1) and ys.shape == (7, 137)
    # Disjoint: every training example lands in at most one client.
    flat = xs.reshape(-1, 784)
    assert torch.unique(flat, dim=0).shape[0] == 7 * 137


@pytest.mark.parametrize("stacked", [False, True])
def test_mlp_apply_loss_accuracy_match_jax(stacked):
    K = 5 if stacked else None
    params = _mlp_params(K)
    rng = np.random.default_rng(0)
    lead = (K, 33) if stacked else (33,)
    x = rng.standard_normal(lead + (28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, lead)
    _, japply = jsmall.make_mnist_mlp(hidden=(32, 16))
    _, tapply = tsmall.make_mnist_mlp(hidden=(32, 16))
    fn = jax.vmap(japply) if stacked else japply
    ref = fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = tapply(params_from_jax(params, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    jloss, jacc = jsmall.nll_loss, jsmall.accuracy
    if stacked:
        jloss, jacc = jax.vmap(jloss), jax.vmap(jacc)
    np.testing.assert_allclose(tsmall.nll_loss(got, yt).numpy(),
                               np.asarray(jloss(ref, yj)), atol=ATOL)
    np.testing.assert_allclose(tsmall.accuracy(got, yt).numpy(),
                               np.asarray(jacc(ref, yj)), atol=1e-7)


def test_local_runner_matches_jax():
    """E local SGD steps on K clients with JAX's minibatch indices; the
    summed-loss backward gives every client its own gradient."""
    K, n_k, batch, steps, lr = 4, 40, 8, 3, 0.05
    params = _mlp_params(K)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((K, n_k, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (K, n_k))
    keys = jax.random.split(jax.random.PRNGKey(9), K)

    _, japply = jsmall.make_mnist_mlp(hidden=(32, 16))
    jopt = jsgd(lr)
    jrun = jax_local_runner(lambda p, a, b: jsmall.nll_loss(japply(p, a), b),
                            jopt, batch, steps)
    jp = jax.tree.map(jnp.asarray, params)
    ref_p, _, ref_loss = jax.vmap(jrun)(jp, jax.vmap(jopt.init)(jp),
                                        jnp.asarray(x), jnp.asarray(y), keys)
    idx = np.stack([np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, n_k))
        for k in jax.random.split(ck, steps)]) for ck in keys])

    _, tapply = tsmall.make_mnist_mlp(hidden=(32, 16))
    opt = sgd(lr)
    run = make_local_runner(lambda p, a, b: tsmall.nll_loss(tapply(p, a), b),
                            opt, batch, steps)
    tp = params_from_jax(params, device="cpu")
    got_p, opt_state, loss = run(tp, opt.init(tp), torch.from_numpy(x),
                                 torch.from_numpy(y), torch.from_numpy(idx))
    assert opt_state.step == steps
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5)
    for a, b in zip(tree_leaves(got_p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
