"""The paper's CIFAR CNN in the port (`repro_torch.models.make_cifar_cnn`)
against the JAX package's on JAX's params carried across by
`params_from_jax` (NHWC inputs, HWIO weights, JAX's names): one model and
K-stacked (one grouped convolution a layer), the per-client gradients,
the parameter count, and the NHWC flatten before ``fc0``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import small as jsmall
from repro.utils import tree_size as jax_tree_size
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import small as tsmall
from repro_torch.utils.pytree import tree_leaves, tree_size

K, B = 3, 4


def _params(hw, seed, K=None):
    """JAX's init for one model, or K models, as numpy."""
    init, _ = jsmall.make_cifar_cnn(hw)
    key = jax.random.PRNGKey(seed)
    p = init(key) if K is None else jax.vmap(init)(jax.random.split(key, K))
    return jax.tree.map(np.asarray, p)


def _images(hw, seed, *lead):
    return np.random.default_rng(seed).standard_normal(
        (*lead, *hw)).astype(np.float32)


# f32 convolutions in another summation order than XLA's: abs/rel 1e-5 on
# the log-probabilities.
@pytest.mark.parametrize("hw", [(32, 32, 3), (8, 8, 3)], ids=["32x32", "8x8"])
def test_apply_matches_jax(hw):
    params = _params(hw, 0)
    x = _images(hw, 1, B)
    _, japply = jsmall.make_cifar_cnn(hw)
    ref = japply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    _, tapply = tsmall.make_cifar_cnn(hw)
    got = tapply(params_from_jax(params, device="cpu"), torch.from_numpy(x))
    assert tuple(got.shape) == (B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(32, 32, 3), (8, 8, 3)], ids=["32x32", "8x8"])
def test_stacked_apply_matches_jax_vmap(hw):
    """K clients, each its own params and batch, as one grouped
    convolution a layer, against ``jax.vmap(apply)``."""
    params = _params(hw, 2, K)
    x = _images(hw, 3, K, B)
    _, japply = jsmall.make_cifar_cnn(hw)
    ref = jax.vmap(japply)(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(x))
    _, tapply = tsmall.make_cifar_cnn(hw)
    got = tapply(params_from_jax(params, device="cpu"), torch.from_numpy(x))
    assert tuple(got.shape) == (K, B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_stacked_apply_runs_one_convolution_a_layer(monkeypatch):
    """The stacked path does not loop over the clients: three convolutions
    for K clients, each with ``groups=K``."""
    hw = (8, 8, 3)
    calls = []
    conv = torch.nn.functional.conv2d

    def counting(*args, **kwargs):
        calls.append(kwargs.get("groups", 1))
        return conv(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", counting)
    _, tapply = tsmall.make_cifar_cnn(hw)
    tapply(params_from_jax(_params(hw, 4, K), device="cpu"),
           torch.from_numpy(_images(hw, 5, K, B)))
    assert calls == [K, K, K]


@pytest.mark.parametrize("hw", [(32, 32, 3), (8, 8, 3)], ids=["32x32", "8x8"])
def test_per_client_gradients_match_jax(hw):
    """The gradient of each client's NLL through the stacked path (one
    backward pass over the sum of the K losses) against
    ``jax.vmap(jax.grad(loss))``: every leaf within 1e-4 of its largest
    entry (f32 sums in another order through three conv layers)."""
    params = _params(hw, 6, K)
    x = _images(hw, 7, K, B)
    y = np.random.default_rng(8).integers(0, 10, (K, B)).astype(np.int32)
    _, japply = jsmall.make_cifar_cnn(hw)

    def jloss(p, x, y):
        return jsmall.nll_loss(japply(p, x), y)

    ref = jax.vmap(jax.grad(jloss))(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), jnp.asarray(y))
    _, tapply = tsmall.make_cifar_cnn(hw)
    p = params_from_jax(params, device="cpu")
    leaves = [v.requires_grad_(True) for v in tree_leaves(p)]
    loss = tsmall.nll_loss(tapply(p, torch.from_numpy(x)),
                           torch.from_numpy(y).long())
    assert tuple(loss.shape) == (K,)
    grads = torch.autograd.grad(loss.sum(), leaves)
    for g, r in zip(grads, jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_parameter_count_is_jax_tree_size():
    """d = 698,250 at 32×32×3, the flat width the round kernels read."""
    init, _ = tsmall.make_cifar_cnn()
    params = init(torch.Generator().manual_seed(0))
    assert tree_size(params) == jax_tree_size(_params((32, 32, 3), 0)) \
        == 698250
    assert {k: {n: tuple(v.shape) for n, v in p.items()}
            for k, p in params.items()} == {
        k: {n: v.shape for n, v in p.items()}
        for k, p in _params((32, 32, 3), 0).items()}
    assert get_config("cifar-cnn")["input_hw"] == (32, 32, 3)


def test_fc0_reads_the_last_pool_in_nhwc_order():
    """JAX flattens the last pool's (2, 2, 200) output (a 16×16 input) in
    NHWC order: the port's output matches JAX's, and the same params with
    fc0's rows taken in NCHW order do not — the check is sensitive to a
    flatten in torch's native layout."""
    hw = (16, 16, 3)
    params = _params(hw, 9)
    x = _images(hw, 10, B)
    _, japply = jsmall.make_cifar_cnn(hw)
    ref = np.asarray(japply(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x)))
    _, tapply = tsmall.make_cifar_cnn(hw)
    got = tapply(params_from_jax(params, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    # fc0 row r of an NCHW flatten is channel r // 4 at pixel r % 4; its
    # NHWC row is (r % 4)·200 + r // 4.
    r = np.arange(800)
    nchw = dict(params, fc0=dict(params["fc0"],
                                 w=params["fc0"]["w"][(r % 4) * 200 + r // 4]))
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    for name in ("conv0", "conv1", "conv2"):
        h = tsmall._conv_relu_pool(h, params_from_jax(params[name],
                                                      device="cpu"))
    h = h.flatten(start_dim=1)            # NCHW order
    p0 = params_from_jax(nchw["fc0"], device="cpu")
    p1 = params_from_jax(params["fc1"], device="cpu")
    logits = torch.relu(h @ p0["w"] + p0["b"]) @ p1["w"] + p1["b"]
    # the NCHW flatten with fc0's rows permuted is the same function ...
    np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    # ... and with JAX's rows as they are, another one
    h_jax_rows = h @ params_from_jax(params["fc0"], device="cpu")["w"]
    assert not np.allclose(h_jax_rows.numpy(),
                           (h @ p0["w"]).numpy(), atol=1e-2)


def test_make_cifar_cnn_init_is_seeded_he_normal():
    init, _ = tsmall.make_cifar_cnn()
    a = init(torch.Generator().manual_seed(0))
    b = init(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    w = a["conv1"]["w"]
    assert abs(float(w.std()) - (2.0 / (9 * 64)) ** 0.5) < 0.01
    assert float(a["conv1"]["b"].abs().max()) == 0.0
