"""The port's non-IID partitioner and label histogram
(`repro_torch.data.synthetic`) against the JAX package's, and the
cifar-like set's shape: the paper's label-sorted sharding (§V) dealt from
JAX's own shard permutation is bitwise JAX's split."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jdata
from repro_torch.data import synthetic as tdata


def _labelled(seed, n, feat=3, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("n,K,spc,shards", [
    (2000, 20, 4, 200),      # MNIST's 4 shards a client
    (1350, 9, 7, 63),        # the scaled CIFAR grid: max(K·spc, 40) shards
    (2037, 27, 7, 200),      # n not a multiple of the shard count
    (500, 5, 8, 40),         # the scaled grid's floor of 40 shards
])
def test_partition_noniid_with_jax_permutation_is_bitwise(n, K, spc, shards):
    x, y = _labelled(n + K, n)
    key = jax.random.PRNGKey(n)
    ref_x, ref_y = jdata.partition_noniid(key, jnp.asarray(x), jnp.asarray(y),
                                          K, spc, num_shards=shards)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, shards)))
    got_x, got_y = tdata.deal_shards(torch.from_numpy(x), torch.from_numpy(y),
                                     perm, K, spc, num_shards=shards)
    assert tuple(got_x.shape) == ref_x.shape
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(ref_y))


def test_partition_noniid_draws_its_permutation_from_the_seed():
    x, y = _labelled(0, 2000)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a = tdata.partition_noniid(3, xt, yt, 20, 4)
    b = tdata.partition_noniid(3, xt, yt, 20, 4)
    c = tdata.partition_noniid(4, xt, yt, 20, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    perm = torch.randperm(200, generator=torch.Generator().manual_seed(3))
    d = tdata.deal_shards(xt, yt, perm, 20, 4)
    assert torch.equal(a[1], d[1])
    # every example dealt at most once
    rows = a[0].reshape(-1, 3).numpy()
    assert len({r.tobytes() for r in rows}) == rows.shape[0] == 20 * 4 * 10


@pytest.mark.parametrize("K,spc,shards", [(51, 4, 200), (6, 7, 40)])
def test_partition_noniid_raises_when_too_few_shards(K, spc, shards):
    x, y = _labelled(1, 1000)
    with pytest.raises(ValueError, match="shards"):
        jdata.partition_noniid(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(y), K, spc, num_shards=shards)
    with pytest.raises(ValueError, match="shards"):
        tdata.partition_noniid(0, torch.from_numpy(x), torch.from_numpy(y),
                               K, spc, num_shards=shards)


@pytest.mark.parametrize("K,n_k,classes", [(20, 40, 10), (3, 7, 4)])
def test_label_histogram_matches_jax(K, n_k, classes):
    ys = np.random.default_rng(K).integers(0, classes, (K, n_k)).astype(
        np.int32)
    ref = jdata.label_histogram(jnp.asarray(ys), classes)
    got = tdata.label_histogram(torch.from_numpy(ys), classes)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)


def test_partition_noniid_label_concentration():
    """``tests/test_substrate.py``'s check: after label-sorted sharding
    each client sees few classes; an IID split sees nearly all."""
    n = 2000
    y = torch.arange(n) % 10
    x = torch.randn(n, 4, generator=torch.Generator().manual_seed(1))
    xs, ys = tdata.partition_noniid(2, x, y, num_clients=20,
                                    shards_per_client=4, num_shards=200)
    hist = tdata.label_histogram(ys, 10)
    assert (hist > 0).sum(axis=1).max() <= 5   # ≤ shards_per_client (+ boundary)
    _, iid_ys = tdata.partition_iid(3, x, y, 20)
    assert (tdata.label_histogram(iid_ys, 10) > 0).sum(axis=1).min() >= 8


def test_cifar_like_config_matches_jax():
    assert (tdata.SyntheticImageConfig.cifar_like()
            == tdata.SyntheticImageConfig(**vars(
                jdata.SyntheticImageConfig.cifar_like())))
    cfg = tdata.SyntheticImageConfig.cifar_like(num_train=64, num_test=16)
    (xtr, ytr), (xte, yte) = tdata.make_synthetic_images(0, cfg,
                                                         device="cpu")
    assert tuple(xtr.shape) == (64, 32, 32, 3) and tuple(yte.shape) == (16,)
    assert int(ytr.min()) >= 0 and int(ytr.max()) <= 9


def test_cifar_prototypes_match_jax_resize():
    """The three-channel prototypes: 4×4×3 noise upsampled to 32×32×3 and
    scaled to unit std, as JAX's (f32 sums of the std in another order)."""
    cfg = jdata.SyntheticImageConfig.cifar_like()
    key = jax.random.PRNGKey(4)
    low = jax.random.normal(key, (cfg.num_classes, cfg.smoothness,
                                  cfg.smoothness, cfg.channels))
    ref = np.asarray(jdata._prototypes(key, cfg))
    got = tdata._prototypes(torch.from_numpy(np.array(low)),
                            tdata.SyntheticImageConfig.cifar_like())
    assert tuple(got.shape) == ref.shape == (10, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=5e-6)
