"""`repro_torch.core.xla_math` against XLA's CPU backend, bit for bit:
``log`` on every f32 of one binade and on a log-uniform sample, and the
features' ``10·log10`` in each of the contexts JAX computes it in (an
eager dispatch, a jitted fusion, a constant folded at compile time), at
the tensor sizes of K × K link matrices (a vectorised loop and its tail)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro_torch.core import clustering as tcl
from repro_torch.core import topology as ttopo
from repro_torch.core.xla_math import db10, xla_log_f32

torch.set_num_threads(1)

_jit_log = jax.jit(jnp.log)
_jit_db = jax.jit(lambda x: 10.0 * jnp.log10(jnp.maximum(x, 1e-12)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _mismatches(got, ref):
    return int(np.count_nonzero(_bits(got) != _bits(ref)))


def _log_uniform(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-12), np.log(1e12), n)).astype(
        np.float32)


def test_log_every_f32_of_one_binade():
    """All 2²³ f32 of [1, 2), in chunks."""
    chunk = 1 << 21
    for start in range(0x3F800000, 0x40000000, chunk):
        x = np.arange(start, start + chunk, dtype=np.uint32).view(np.float32)
        got = xla_log_f32(torch.from_numpy(x)).numpy()
        assert _mismatches(got, _jit_log(x)) == 0, hex(start)


def test_log_uniform_sample_and_a_correctly_rounded_log_differs():
    """2²² log-uniform values in [1e-12, 1e12]: XLA's bits, where numpy's
    log (and so a correctly rounded one) differs in a few per cent."""
    x = _log_uniform(1 << 22)
    ref = _jit_log(x)
    for part in np.array_split(np.arange(x.size), 4):
        got = xla_log_f32(torch.from_numpy(x[part])).numpy()
        assert _mismatches(got, np.asarray(ref)[part]) == 0
    assert _mismatches(np.log(x), ref) > 0.01 * x.size


def test_log_special_values():
    # No subnormal: whether XLA's threads flush them depends on the
    # process, and no feature reaches one (the clamp at 1e-12).
    x = np.array([0.0, -1.0, np.inf, np.nan, 1.1754944e-38, 1.0,
                  3.4028235e38], np.float32)
    got = xla_log_f32(torch.from_numpy(x)).numpy()
    ref = np.asarray(_jit_log(x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert _mismatches(got[ok], ref[ok]) == 0


def test_log_and_fma_run_under_vmap():
    """A Monte-Carlo sweep maps a round's channel view, the dB of its link
    SNRs included, over its trajectories with ``torch.func.vmap``: the
    same bits as each row alone."""
    from repro_torch.core.xla_math import _fma_f32

    x = torch.from_numpy(_log_uniform(3 * 257, seed=5).reshape(3, 257))
    got = torch.func.vmap(lambda r: db10(r, "jit"))(x)
    for row, want in zip(got, x):
        assert _mismatches(row.numpy(), db10(want, "jit").numpy()) == 0
    c = x * 1e-3
    got = torch.func.vmap(_fma_f32)(x, x, c)
    assert _mismatches(got.numpy(), _fma_f32(x, x, c).numpy()) == 0


@pytest.mark.parametrize("n", [1, 37, 64, 256, 2500, 4099])
def test_db_eager_and_jitted_match_xla(n):
    """``10 * jnp.log10(jnp.maximum(x, 1e-12))`` eagerly (log10's fusion,
    then ×10) and under ``jit`` (one folded constant): the two differ in
    about half the values, and each is matched."""
    x = _log_uniform(n, seed=n)
    x[: n // 7] = 0.0                          # clamped to 1e-12
    eager = np.asarray(10.0 * jnp.log10(jnp.maximum(jnp.asarray(x),
                                                    1e-12)))
    jitted = np.asarray(_jit_db(x))
    assert _mismatches(db10(torch.from_numpy(x), "eager").numpy(),
                       eager) == 0
    assert _mismatches(db10(torch.from_numpy(x), "jit").numpy(),
                       jitted) == 0
    if n >= 256:
        assert _mismatches(eager, jitted) > 0


def test_db_folded_matches_xla_constant_folding():
    """With the input a constant of the trace XLA evaluates the features
    at compile time."""
    x = _log_uniform(20000, seed=3)
    ref = np.asarray(jax.jit(
        lambda: 10.0 * jnp.log10(jnp.maximum(jnp.asarray(x), 1e-12)))())
    assert _mismatches(db10(torch.from_numpy(x), "folded").numpy(),
                       ref) == 0
    with pytest.raises(ValueError, match="mode"):
        db10(torch.from_numpy(x), "fast")


@pytest.mark.parametrize("K", [8, 16, 50])
def test_snr_features_match_jax_in_each_context(K):
    """The features on JAX's link SNRs at topology seeds 0–24: eagerly,
    under ``jit`` and folded, bitwise."""
    tcfg = jtopo.TopologyConfig(num_clients=K)
    for seed in range(25):
        top = jtopo.make_topology(jax.random.PRNGKey(seed), tcfg)
        snr, adj = np.asarray(top.link_snr), np.asarray(top.adjacency)
        ts, ta = torch.from_numpy(snr.copy()), torch.from_numpy(adj.copy())
        refs = {"eager": jcl.snr_features(snr, adj),
                "jit": jax.jit(jcl.snr_features)(snr, adj),
                "folded": jax.jit(lambda: jcl.snr_features(snr, adj))()}
        for mode, ref in refs.items():
            got = tcl.snr_features(ts, ta, db_mode=mode).numpy()
            assert _mismatches(got, ref) == 0, (seed, mode)


@pytest.mark.parametrize("K", [8, 16, 50])
def test_link_snr_within_five_ulp_of_jax(K):
    """The port's channel view is not bitwise (ROADMAP §3): at topology
    seeds 0–24 its eager link SNRs, from JAX's gains, are within 5 f32
    ulp of JAX's (|h|² is not XLA's complex abs squared), and its outage
    graph, whose dB threshold is taken on XLA's bits, is JAX's."""
    tcfg = jtopo.TopologyConfig(num_clients=K)
    worst = 0
    for seed in range(25):
        top = jtopo.make_topology(jax.random.PRNGKey(seed), tcfg)
        snr, adj = ttopo.link_stats(
            torch.from_numpy(np.array(top.link_gain)),
            ttopo.TopologyConfig(num_clients=K))
        d = (snr.numpy().view(np.int32).astype(np.int64)
             - np.asarray(top.link_snr).view(np.int32).astype(np.int64))
        worst = max(worst, int(np.abs(d).max()))
        np.testing.assert_array_equal(adj.numpy(), np.asarray(top.adjacency))
    assert worst <= 5
