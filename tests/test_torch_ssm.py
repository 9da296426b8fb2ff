"""The port's mamba mixer (`repro_torch.models.ssm`) against the JAX
package on identical numpy inputs and JAX's ``mamba_init`` weights: the
discretized coefficients, the chunked selective scan with a carried
state, the causal conv with its state, the whole mixer with its decode
cache (prefill, then one token at a time), in f32 and bf16; and the JAX
package's own ``tests/test_recurrent_cells.py`` checks run on the port
(the chunked scan against the sequential recurrence, chunk invariance
with padding).

Tolerances: f32 1e-5 absolute, or 1e-5 of the largest magnitude where
the scan's state grows past 1 (the doubling scan multiplies the
transitions in another order than JAX's ``associative_scan``, exp and the
products rounding otherwise); bf16 one part in 50 of the largest
magnitude (the mixer's products and its output rounded to bf16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import LayerSpec as JaxLayerSpec
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ArchConfig, LayerSpec

ATOL = 1e-5
REL = 1e-5
BF16_REL = 2e-2


def _cfgs(d_model=32, chunk=8, dtype="float32"):
    kw = dict(name="t", arch_type="ssm", num_layers=1, d_model=d_model,
              num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=64,
              ssm_chunk=chunk, param_dtype=dtype, compute_dtype=dtype)
    return (JaxArchConfig(pattern=(JaxLayerSpec("mamba", 0, "none"),), **kw),
            ArchConfig(pattern=(LayerSpec("mamba", 0, "none"),), **kw))


def _params(jcfg, seed=0):
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg.d_model,
                         jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_conv,
                         jcfg.dt_rank, jcfg.pdtype)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def test_softplus_is_jaxs_without_a_threshold():
    x = np.linspace(-40.0, 60.0, 1001).astype(np.float32)
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-7)


def test_ssm_coeffs_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    xz = np.random.default_rng(1).standard_normal(
        (2, 13, jcfg.d_inner)).astype(np.float32)
    valid = np.arange(13) < 9
    want = jssm._ssm_coeffs(jp, jnp.asarray(xz), jcfg.ssm_state,
                            jcfg.dt_rank, valid=jnp.asarray(valid))
    got = tssm._ssm_coeffs(tp, torch.from_numpy(xz), tcfg.ssm_state,
                           tcfg.dt_rank, valid=torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL)
    dA, dBu, _ = got
    assert float((dA[:, 9:] - 1).abs().max()) == 0.0      # identity steps
    assert float(dBu[:, 9:].abs().max()) == 0.0


@pytest.mark.parametrize("L,chunk,with_h0", [(21, 8, True), (21, 64, True),
                                             (16, 8, False), (1, 8, True)])
def test_selective_scan_matches_jax(L, chunk, with_h0):
    """y and the final state, a carried h0 included; 21 tokens in chunks
    of 8 pad the last chunk; one token is a decode step."""
    jcfg, tcfg = _cfgs(chunk=chunk)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(L + chunk)
    xz = rng.standard_normal((2, L, jcfg.d_inner)).astype(np.float32)
    h0 = (rng.standard_normal((2, jcfg.d_inner, jcfg.ssm_state))
          .astype(np.float32) if with_h0 else None)
    want = jssm.selective_scan(jp, jnp.asarray(xz), jcfg.ssm_state,
                               jcfg.dt_rank, chunk,
                               h0=None if h0 is None else jnp.asarray(h0))
    got = tssm.selective_scan(tp, torch.from_numpy(xz), tcfg.ssm_state,
                              tcfg.dt_rank, chunk,
                              h0=None if h0 is None else torch.from_numpy(h0))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_rel(g, w)


def test_selective_scan_sequential_reference():
    """The chunked doubling scan against the step-by-step recurrence."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    xz = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 21, tcfg.d_inner)).astype(np.float32))
    y, h = tssm.selective_scan(tp, xz, tcfg.ssm_state, tcfg.dt_rank, chunk=8)
    dA, dBu, Cc = tssm._ssm_coeffs(tp, xz, tcfg.ssm_state, tcfg.dt_rank)
    hh = torch.zeros(2, tcfg.d_inner, tcfg.ssm_state)
    ys = []
    for t in range(21):
        hh = dA[:, t] * hh + dBu[:, t]
        ys.append(torch.einsum("bdn,bn->bd", hh, Cc[:, t])
                  + tp["D"] * xz[:, t])
    _close_rel(y, torch.stack(ys, dim=1))
    _close_rel(h, hh)


def test_mamba_chunk_invariance_with_padding():
    """Padded steps are identity transitions: the carried state is not
    decayed by them."""
    _, t8 = _cfgs(chunk=8)
    _, t64 = _cfgs(chunk=64)
    _, tp = _params(_cfgs()[0])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 19, 32)).astype(np.float32))
    y8, c8 = tssm.mamba_apply(tp, x, t8)
    y64, c64 = tssm.mamba_apply(tp, x, t64)
    _close_rel(y8, y64)
    _close_rel(c8["h"], c64["h"])


def test_causal_conv_matches_jax_with_its_state():
    rng = np.random.default_rng(3)
    xz = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    state = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for st in (None, state):
        want = jssm.causal_conv(jnp.asarray(xz), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
        got = tssm.causal_conv(torch.from_numpy(xz), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if st is None else torch.from_numpy(st))
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(wnt), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_with_its_cache_matches_jax(dtype):
    """Prefill over 11 tokens (no cache), then 5 more in one call and 1
    in another, each from the previous call's cache: outputs and the
    conv and h states."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 17, 32)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jcache = tcache = None
    for part in (slice(0, 11), slice(11, 16), slice(16, 17)):
        want, jcache = jssm.mamba_apply(jp, jx[:, part], jcfg, jcache)
        got, tcache = tssm.mamba_apply(tp, tx[:, part], tcfg, tcache)
        assert got.dtype == tx.dtype
        assert tcache["conv"].dtype == tx.dtype
        assert tcache["h"].dtype == torch.float32
        rel = REL if dtype == "float32" else BF16_REL
        for g, w in ((got, want), (tcache["conv"], jcache["conv"]),
                     (tcache["h"], jcache["h"])):
            _close_rel(g, w, rel)


def test_mamba_init_draws_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    p = tssm.mamba_init(gen, 64, 128, 16, 4, 4, torch.bfloat16, "cpu",
                        lead=(3,))
    assert p["in_proj"].shape == (3, 64, 256)
    assert p["conv_w"].shape == (3, 4, 128)
    assert p["x_proj"].shape == (3, 128, 4 + 32)
    dt = tssm.softplus(p["dt_bias"])
    assert p["dt_bias"].dtype == torch.float32
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6
    np.testing.assert_allclose(torch.exp(p["A_log"][1, 5]).numpy(),
                               np.arange(1, 17), rtol=1e-6)
    assert float((p["D"] - 1).abs().max()) == 0.0
