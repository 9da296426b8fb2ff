"""The port's CWFL round (plain version and the wrapper's CPU route)
against the JAX package's Pallas kernel (interpret mode) and its jnp
oracle, on identical numpy inputs, unguarded and guarded."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cwfl_round import cwfl_round as jax_cwfl_round
from repro.kernels.cwfl_round import hbm_bytes_model as jax_hbm_bytes_model
from repro.kernels.ref import cwfl_round_ref as jax_cwfl_round_ref
from repro_torch.kernels import cwfl_round as kmod
from repro_torch.kernels.cwfl_round import cwfl_round, hbm_bytes_model
from repro_torch.kernels.ref import cwfl_round_ref

# f32 sums taken in another order than XLA's: the JAX kernel itself drifts
# up to 1.9e-6 from its own oracle at (16, 4, 2049), so hold to 1e-5 abs.
F32_ATOL = 1e-5


def _inputs(K, C, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, d)).astype(np.float32),
            rng.uniform(size=(C, K)).astype(np.float32),
            (0.1 * rng.standard_normal((C, d))).astype(np.float32),
            rng.uniform(size=(C, C)).astype(np.float32),
            (0.1 * rng.standard_normal((C, d))).astype(np.float32),
            rng.uniform(size=(K, C)).astype(np.float32))


def _jax(fn, args, dtype=jnp.float32):
    s, *rest = (jnp.asarray(a) for a in args)
    new, cons = fn(s.astype(dtype), *rest)
    return np.asarray(new.astype(jnp.float32)), np.asarray(cons)


def _torch(fn, args, dtype=torch.float32, **kw):
    s, *rest = (torch.from_numpy(a) for a in args)
    new, cons = fn(s.to(dtype), *rest, **kw)
    assert new.dtype == dtype and cons.dtype == torch.float32
    return new.float().numpy(), cons.numpy()


@pytest.mark.parametrize("K,C,d", [(8, 3, 2048), (12, 3, 1337),
                                   (16, 4, 2049), (1, 3, 700), (9, 1, 700)])
@pytest.mark.parametrize("port", ["ref", "cpu_route"])
def test_cwfl_round_matches_jax(K, C, d, port):
    args = _inputs(K, C, d)
    fn = cwfl_round_ref if port == "ref" else cwfl_round
    new, cons = _torch(fn, args)
    assert new.shape == (K, d) and cons.shape == (d,)
    for ref in (_jax(jax_cwfl_round, args), _jax(jax_cwfl_round_ref, args)):
        np.testing.assert_allclose(new, ref[0], atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(cons, ref[1], atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("port", ["ref", "cpu_route"])
def test_cwfl_round_bf16_signals_match_jax(port):
    """bf16 S: f32 sums, ``new`` rounded to bf16.  The two sides may round a
    value that sits on a bf16 rounding boundary apart by one bf16 ulp
    (2^-7 relative), after f32 sums that differ by up to F32_ATOL."""
    args = _inputs(8, 3, 2048, seed=1)
    fn = cwfl_round_ref if port == "ref" else cwfl_round
    new, cons = _torch(fn, args, dtype=torch.bfloat16)
    ref_new, ref_cons = _jax(jax_cwfl_round, args, dtype=jnp.bfloat16)
    np.testing.assert_allclose(new, ref_new, rtol=2.0 ** -7, atol=F32_ATOL)
    np.testing.assert_allclose(cons, ref_cons, atol=F32_ATOL, rtol=0)


def _poisoned(K, C, d, seed):
    """Inputs of a fault round: NaN and ±inf in S (one NaN client under a
    zero Ã column), and one all-zero Ã row whose noise is not zero."""
    s, a, n1, b, n2, m = _inputs(K, C, d, seed)
    rng = np.random.default_rng(seed + 1)
    bad = rng.uniform(size=s.shape) < 0.01
    s[bad] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                        int(bad.sum()))
    s[K - 1, ::5] = np.nan
    a[:, K - 1] = 0.0
    a[C - 1] = 0.0
    return s, a, n1, b, n2, m


def test_cwfl_round_ref_guard_matches_jax():
    """Non-finite signals are zeroed and a dead Ã row zeroes its θ̃ row."""
    s, a, n1, b, n2, m = _inputs(10, 3, 700, seed=2)
    s[3, ::7] = np.nan
    s[5, ::11] = np.inf
    a[1] = 0.0
    args = (s, a, n1, b, n2, m)
    new, cons = _torch(cwfl_round_ref, args, guard=True)
    sj, *rest = (jnp.asarray(x) for x in args)
    ref_new, ref_cons = jax_cwfl_round_ref(sj, *rest, guard=True)
    assert np.all(np.isfinite(new)) and np.all(np.isfinite(cons))
    np.testing.assert_allclose(new, np.asarray(ref_new), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(cons, np.asarray(ref_cons), atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("K,C,d", [(8, 3, 2048), (16, 4, 2049), (1, 3, 700),
                                   (9, 1, 700)])
@pytest.mark.parametrize("port", ["ref", "cpu_route"])
def test_cwfl_round_guard_matches_jax(K, C, d, port):
    """The guarded round (kernel 2) against JAX's guarded Pallas kernel in
    interpret mode and its guarded oracle, on a poisoned fault round.  At
    K=1 the one client is the NaN client under a zero column; at C=1 the
    one row is dead."""
    args = _poisoned(K, C, d, seed=K + C)
    fn = functools.partial(cwfl_round_ref if port == "ref" else cwfl_round,
                           guard=True)
    new, cons = _torch(fn, args)
    assert np.all(np.isfinite(new)) and np.all(np.isfinite(cons))
    for jfn in (functools.partial(jax_cwfl_round, interpret=True,
                                  guard=True),
                functools.partial(jax_cwfl_round_ref, guard=True)):
        ref = _jax(jfn, args)
        np.testing.assert_allclose(new, ref[0], atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(cons, ref[1], atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("port", ["ref", "cpu_route"])
def test_cwfl_round_guard_bf16_signals_match_jax(port):
    """bf16 S through the guard: within one bf16 ulp + F32_ATOL."""
    args = _poisoned(8, 3, 2048, seed=5)
    fn = functools.partial(cwfl_round_ref if port == "ref" else cwfl_round,
                           guard=True)
    new, cons = _torch(fn, args, dtype=torch.bfloat16)
    assert np.all(np.isfinite(new)) and np.all(np.isfinite(cons))
    ref_new, ref_cons = _jax(functools.partial(jax_cwfl_round,
                                               interpret=True, guard=True),
                             args, dtype=jnp.bfloat16)
    np.testing.assert_allclose(new, ref_new, rtol=2.0 ** -7, atol=F32_ATOL)
    np.testing.assert_allclose(cons, ref_cons, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("K,C,d,itemsize", [(50, 3, 184214, 4),
                                            (8, 3, 2048, 2)])
def test_hbm_bytes_model_matches_jax(K, C, d, itemsize):
    assert hbm_bytes_model(K, C, d, itemsize) == jax_hbm_bytes_model(
        K, C, d, itemsize)


def test_cwfl_round_cpu_route_does_not_launch():
    before = kmod.launches
    _torch(cwfl_round, _inputs(4, 2, 256))
    assert kmod.launches == before


def test_cwfl_round_guard_cpu_route_does_not_launch():
    before = (kmod.launches, kmod.launches_guard)
    _torch(cwfl_round, _poisoned(4, 2, 256, seed=0), guard=True)
    assert (kmod.launches, kmod.launches_guard) == before


@pytest.mark.parametrize("bad", ["phase1_shape", "noise_dtype",
                                 "signals_dtype", "signals_rank"])
def test_cwfl_round_rejects_what_the_kernel_does_not_take(bad):
    s, a, n1, b, n2, m = (torch.from_numpy(x) for x in _inputs(4, 2, 256))
    if bad == "phase1_shape":
        a = a[:, :3]
    elif bad == "noise_dtype":
        n1 = n1.double()
    elif bad == "signals_dtype":
        s = s.half()
    else:
        s = s[None]
    with pytest.raises((ValueError, TypeError)):
        cwfl_round(s, a, n1, b, n2, m)
