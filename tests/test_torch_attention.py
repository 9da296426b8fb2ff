"""The port's attention and layers against the JAX package on identical
numpy inputs: ``flash_attention`` (plain version and the wrapper's CPU
route) against JAX's oracle and its Pallas kernel in interpret mode, the
model-layout op against the model's chunked attention, decode attention,
and the shared layers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.kernels.ref import flash_attention_ref as jax_fa_ref
from repro.models import layers as jlayers
from repro.models.attention import decode_attention_delta as jax_decode
from repro.models.attention import flash_attention as jax_model_fa
from repro_torch.kernels import flash_attention as kmod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers as tlayers
from repro_torch.models.attention import decode_attention_delta

# JAX's own tolerances for its kernel against its oracle
# (tests/test_kernels.py): f32 sums in another order, and bf16 outputs.
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
LAYER_TOL = 1e-6


def _qkv(B, H, KV, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KV, Skv, D)).astype(np.float32),
            rng.standard_normal((B, KV, Skv, D)).astype(np.float32))


def _both(args, dtype):
    """The same inputs in both packages, rounded once to ``dtype``."""
    return ([jnp.asarray(a).astype(dtype) for a in args],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _against_jax(args, dtype, block, **mode):
    """The port's plain version and CPU route against JAX's oracle and
    Pallas kernel (``interpret=None`` resolves to interpret mode off the
    TPU, as in the JAX package's tests)."""
    (jq, jk, jv), (tq, tk, tv) = _both(args, dtype)
    want_ref = _np(jax_fa_ref(jq, jk, jv, **mode))
    want_kernel = _np(jax_fa(jq, jk, jv, block_q=block, block_k=block,
                             **mode))
    launches = kmod.launches
    for got in (flash_attention_ref(tq, tk, tv, **mode),
                flash_attention(tq, tk, tv, **mode)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                                       rtol=TOL[dtype])
    assert kmod.launches == launches     # the CPU route launches nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,D", [(1, 2, 1, 100, 32),
                                        (2, 6, 2, 64, 64),
                                        (1, 2, 1, 40, 256)])
def test_flash_attention_matches_jax(B, H, KV, S, D, dtype):
    """JAX's grid (``test_flash_attention_matches_ref``: ragged S = 100,
    GQA) and Gemma-2's head dim 256, causal."""
    _against_jax(_qkv(B, H, KV, S, S, D, seed=S + D), dtype, block=64)


@pytest.mark.parametrize("window,cap,causal", [(0, 0.0, True),
                                               (64, 0.0, True),
                                               (32, 50.0, True),
                                               (0, 30.0, False)])
def test_flash_attention_masking_modes_match_jax(window, cap, causal):
    """JAX's masking modes at (1, 4, 192, 64) with 2 KV heads: every row
    has a valid key in each (the row with none is where the kernels and
    the oracle part ways, see `repro_torch.kernels.flash_attention`)."""
    _against_jax(_qkv(1, 4, 2, 192, 192, 64, seed=7), "float32", block=64,
                 causal=causal, window=window, cap=cap)


def test_flash_attention_ragged_cross_lengths_match_jax():
    """Sq ≠ Skv, neither a multiple of the block, softcapped, non-causal
    (every key valid for every row)."""
    _against_jax(_qkv(2, 4, 2, 37, 150, 32, seed=3), "float32", block=64,
                 causal=False, cap=20.0)


def test_flash_attention_op_matches_model_attention():
    """The model-layout op against the JAX model's chunked attention
    (``test_flash_kernel_matches_model_attention``'s case)."""
    rng = np.random.default_rng(11)
    B, S, H, KV, D = 2, 96, 4, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    want = np.asarray(jax_model_fa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, block=32))
    got = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each value, taken at 1/64 for
    smaller ones: those are sums that cancel, and the f32 rounding of
    their terms in another order (JAX's chunked softmax, the plain
    version's exact one) exceeds their own ulp."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6))) - 7)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_attention_op_scales_q_in_bf16_as_the_model(D):
    """In bf16 the JAX model scales q by D^-0.5 in q's dtype before the
    products (`repro.models.attention.flash_attention`: the scale rounded
    to bf16, the product rounded once); the op does the same, so its
    output is within one bf16 ulp of JAX's at every head dim.  q is
    scaled by 4, so that the scores are large enough for q's rounding to
    show: at D = 128 and 32 the scale is no power of two, and scaling q
    in f32 instead misses by a hundred ulp."""
    rng = np.random.default_rng(D)
    B, S, H, KV = 2, 96, 4, 2
    args = [(4 * rng.standard_normal((B, S, H, D))).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32)]
    (jq, jk, jv), (tq, tk, tv) = _both(args, "bfloat16")
    want = _np(jax_model_fa(jq, jk, jv, causal=True, block=32))
    got = flash_attention_op(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    assert np.all(np.abs(_np(got) - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "groups", "dtype",
                                 "device"])
def test_flash_attention_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 32, 0))
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :, :4]
    elif bad == "groups":
        k, v = torch.cat([k, k[:, :1]], 1), torch.cat([v, v[:, :1]], 1)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v)


@pytest.mark.parametrize("case", ["full", "window", "ring"])
def test_decode_attention_delta_matches_jax(case):
    """One token against a read-only cache, merged with its own k, v:
    a padded full cache, a windowed one, and a ring buffer with its
    ``kv_valid`` mask, softcapped, with 4 query heads on 2 KV heads."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D, pos = 2, 24, 4, 2, 32, 19
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, KV, D)).astype(np.float32)
              for _ in range(2))
    kw = {"cap": 50.0}
    if case == "window":
        kw["window"] = 6
    elif case == "ring":
        idx = np.arange(S)
        kw["kv_valid"] = (idx < pos) & (idx != pos % S)
    want = np.asarray(jax_decode(
        *(jnp.asarray(a) for a in (q, kc, vc, kn, vn)), pos,
        **{k: jnp.asarray(v) if k == "kv_valid" else v
           for k, v in kw.items()}))
    got = decode_attention_delta(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), pos,
        **{k: torch.from_numpy(v) if k == "kv_valid" else v
           for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_rmsnorm_layernorm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        want = np.asarray(jlayers.norm(jnp.asarray(x), jnp.asarray(scale),
                                       kind))
        got = tlayers.norm(torch.from_numpy(x), torch.from_numpy(scale),
                           kind)
        np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL)


@pytest.mark.parametrize("theta,start", [(1e4, 0), (1e6, 0), (1e4, 4600)])
def test_rope_matches_jax(theta, start):
    """Half-split rotary embedding at Gemma-2's and Qwen-2.5's bases, near
    the start of a sequence and at Gemma-2's full prompt length."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)
    pos = np.arange(start, start + 20)[None].repeat(2, 0)
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {name: (0.2 * rng.standard_normal(shape)).astype(np.float32)
         for name, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                             ("w_down", (64, 32)))}
    want = np.asarray(jlayers.swiglu({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x)))
    got = tlayers.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL)


def test_softcap_matches_jax():
    """cap · tanh(x / cap) at Gemma-2's final cap, over logits up to
    ±60: 1e-6 relative (tanh's f32 rounding differs by an ulp)."""
    x = np.linspace(-60, 60, 1001, dtype=np.float32)
    want = np.asarray(jlayers.softcap(jnp.asarray(x), 30.0))
    got = tlayers.softcap(torch.from_numpy(x), 30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_array_equal(
        tlayers.softcap(torch.from_numpy(x), 0.0).numpy(), x)
