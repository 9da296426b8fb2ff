"""`repro_torch.core.xla_math` against XLA's CPU backend, bit for bit:
``log`` on every f32 of one binade and on a log-uniform sample, and the
features' ``10·log10`` in each of the contexts JAX computes it in (an
eager dispatch, a jitted fusion, a constant folded at compile time), at
the tensor sizes of K × K link matrices (a vectorised loop and its tail);
glibc's ``powf`` and XLA's complex ``abs``; and the channel process's
step and view, eagerly and under ``jit``, at topology seeds 0–24.
`tests/test_torch_channel_xla.py` taps the engine's own rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro.sim import processes as jproc
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS
from repro_torch.convert import topology_from_arrays
from repro_torch.core import clustering as tcl
from repro_torch.core import topology as ttopo
from repro_torch.core.xla_math import (db10, glibc_powf, sqrt_f32, xla_abs,
                                       xla_log_f32)
from repro_torch.sim import processes as tproc
from repro_torch.sim.scenarios import get_scenario

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
    """A drawn topology's eager pathloss, link SNRs and outage graph, from
    JAX's positions and gains, are JAX's bit for bit at topology seeds
    0–24 (PR 27 held the SNRs within 5 ulp: |h|² was not XLA's complex
    abs squared); so is the channel process's first state."""
    tcfg = jtopo.TopologyConfig(num_clients=K)
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    for seed in range(25):
        top = jtopo.make_topology(jax.random.PRNGKey(seed), tcfg)
        got = topology_from_arrays(np.asarray(top.positions),
                                   np.asarray(top.link_gain), ttcfg,
                                   device="cpu")
        assert _mismatches(got.link_snr.numpy(), top.link_snr) == 0, seed
        np.testing.assert_array_equal(got.adjacency.numpy(),
                                      np.asarray(top.adjacency))
        pl = ttopo.pathloss_amplitude(got.positions, ttcfg)
        assert _mismatches(pl.numpy(), jtopo.pathloss_amplitude(
            top.positions, tcfg)) == 0, seed
        ref = jproc.init_channel(top, tcfg, jax.random.PRNGKey(1))
        chan = tproc.init_channel(got, ttcfg, torch.zeros(K, 2))
        assert np.array_equal(chan.h_tilde.numpy().view(np.uint64),
                              np.asarray(ref.h_tilde).view(np.uint64)), seed


def test_glibc_powf_at_the_pathloss_exponent():
    """2²⁰ log-uniform bases in [1e-3, 1e4] at −1.1 (the pathloss
    exponent −ς/2): XLA's ``pow`` bits, which an f64 ``pow`` rounded to
    f32 misses in a few hundred."""
    rng = np.random.default_rng(11)
    x = np.exp(rng.uniform(np.log(1e-3), np.log(1e4), 1 << 20)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a: a ** -1.1)(x))
    got = glibc_powf(torch.from_numpy(x), -1.1).numpy()
    assert _mismatches(got, ref) == 0
    f64 = (x.astype(np.float64) ** np.float64(np.float32(-1.1))).astype(
        np.float32)
    assert _mismatches(f64, ref) > 100


def test_glibc_powf_of_ten():
    """10 to 2²⁰ exponents in [−8, 8] (the shadowing's 10^(s/20))."""
    e = np.random.default_rng(12).uniform(-8, 8, 1 << 20).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a: 10.0 ** a)(e))
    got = glibc_powf(torch.tensor(10.0), torch.from_numpy(e)).numpy()
    assert _mismatches(got, ref) == 0


def test_glibc_powf_special_values():
    x = np.array([0.0, 1.0, np.inf, np.nan, 2.0, 0.5, -2.0, -2.0, -8.0,
                  3.0, 3.0, 1e30, 1e-30], np.float32)
    y = np.array([-1.1, np.nan, -1.1, 2.0, 0.0, np.inf, 3.0, 2.0, 1.0 / 3,
                  200.0, -200.0, 5.0, 5.0], np.float32)
    ref = np.asarray(jax.jit(jnp.power)(x, y))
    got = glibc_powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert _mismatches(got[ok], ref[ok]) == 0


def test_xla_abs_of_random_and_edge_values():
    """XLA's complex ``abs`` of 2¹⁸ random gains over twelve decades, and
    of zeros, infinities, NaNs and subnormal parts."""
    rng = np.random.default_rng(13)
    n = 1 << 18
    mag = np.exp(rng.uniform(np.log(1e-6), np.log(1e6), (2, n)))
    z = (mag[0] * rng.standard_normal(n)
         + 1j * mag[1] * rng.standard_normal(n)).astype(np.complex64)
    edge = np.array([0, 1e-40, 3e-39 + 4e-39j, 1j * 1e-40, np.inf,
                     1j * np.inf, complex(np.inf, np.inf),
                     complex(np.nan, 1), complex(1, np.nan), -0.0,
                     complex(-3, 4), complex(3e38, 3e38)], np.complex64)
    for z in (z, edge):
        ref = np.asarray(jax.jit(jnp.abs)(z))
        got = xla_abs(torch.from_numpy(z.real.copy()),
                      torch.from_numpy(z.imag.copy())).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert _mismatches(got[ok], ref[ok]) == 0


def test_sqrt_f32_is_correctly_rounded():
    """ATen's vectorised f32 ``sqrt`` misses the last bit of some values;
    `sqrt_f32` is IEEE's, and XLA's ``vsqrtps``."""
    x = np.random.default_rng(14).uniform(1.0, 1.2, 1 << 16).astype(
        np.float32)
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert _mismatches(sqrt_f32(torch.from_numpy(x)).numpy(), ref) == 0
    assert _mismatches(np.asarray(jax.jit(jnp.sqrt)(x)), ref) == 0


# JAX's normal is √2·erf_inv(u); the port's channel draws are erf_inv(u).
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_erf_inv_draw = jax.jit(
    lambda key, shape: jax.lax.erf_inv(jax.random.uniform(
        key, shape, jnp.float32, _LO, 1.0)), static_argnums=1)


def _channel_draws(key, K):
    k_fade, k_shadow, k_way = jax.random.split(key, 3)
    k_re, k_im = jax.random.split(k_fade)
    return tproc.ChannelDraws(
        *(torch.from_numpy(np.asarray(_erf_inv_draw(k, (K, K))))
          for k in (k_re, k_im, k_shadow)),
        waypoints=torch.from_numpy(np.asarray(
            jax.random.uniform(k_way, (K, 2)))))


def _assert_same(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and np.array_equal(
        got.view(np.uint8), ref.view(np.uint8)), what


@pytest.mark.parametrize("K", [8, 16, 50])
def test_channel_step_and_view_match_jax_at_every_seed(K):
    """The cluster-churn channel process under ``jit``, as JAX's round
    computes it: at topology seeds 0–24, ten rounds of the step and the
    view (state, gains, SNRs, outage graph) are JAX's bit for bit."""
    tcfg = jtopo.TopologyConfig(num_clients=K)
    ttcfg = ttopo.TopologyConfig(num_clients=K)
    pcfg = JAX_SCENARIOS["cluster-churn"].channel
    tpcfg = get_scenario("cluster-churn").channel
    round_ = jax.jit(lambda s, k: (lambda n: (n, jproc.channel_view(
        n, tcfg)))(jproc.step_channel(s, pcfg, tcfg, k)))
    for seed in range(25):
        top = jtopo.make_topology(jax.random.PRNGKey(seed), tcfg)
        ref = jproc.init_channel(top, tcfg, jax.random.PRNGKey(seed + 100))
        got = tproc.ChannelState(*(torch.from_numpy(np.array(x))
                                   for x in ref))
        for t, key in enumerate(jax.random.split(jax.random.PRNGKey(seed),
                                                 10)):
            ref, view = round_(ref, key)
            got, tview = tproc.step_and_view(got, tpcfg, ttcfg,
                                             _channel_draws(key, K))
            for name, a, b in zip(ref._fields + view._fields,
                                  tuple(got) + tuple(tview),
                                  tuple(ref) + tuple(view)):
                _assert_same(a.numpy(), b, (seed, t, name))
