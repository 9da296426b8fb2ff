"""The port's MoE (`repro_torch.models.moe`) and qk_norm attention against
the JAX package on identical numpy inputs: ``moe_apply``'s output and aux
loss with and without drops, over shards, in f32 and bf16; the capacity
formula; the sort-based dispatch against a dense reference (the JAX
package's own ``tests/test_moe.py``, run on the port); qk_norm before
RoPE in ``_qkv``; the sliced expert draws.

Tolerances: f32 1e-5 absolute (the same function, sums in other orders:
ATen's batched products against XLA's einsums, a sum over k against a
scatter-add); bf16 one part in 50 of the output's largest magnitude (the
expert products and the combine rounded to bf16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import normal_init

ATOL = 1e-5
BF16_REL = 2e-2
D, FF, E = 32, 64, 4


@pytest.fixture(scope="module")
def params():
    """JAX's ``moe_init`` draws in both packages."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), D, FF, E, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(T, seed, skewed=False):
    """(T, D) unit normals; ``skewed``: one token repeated, so every token
    routes to the same experts and a capacity below T drops pairs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1 if skewed else T, D)).astype(np.float32)
    return np.broadcast_to(x, (T, D)).copy()


def _dense_ref(p, x, k):
    """No-capacity reference in the port: y = Σ_topk p_e · expert_e(x)."""
    probs = torch.softmax(x @ p["router"], -1)
    tp, te = torch.topk(probs, k, dim=-1)
    tp = tp / tp.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for i in range(k):
        e = te[:, i]
        g = F.silu(torch.einsum("td,tdf->tf", x, p["w_gate"][e]))
        u = torch.einsum("td,tdf->tf", x, p["w_up"][e])
        y += tp[:, i:i + 1] * torch.einsum("tf,tfd->td", g * u,
                                           p["w_down"][e])
    return y


# (T, top_k, capacity_factor, shards, skewed): dropless, dropping (skewed
# and at cf 0.5 on random tokens), shard-local dispatch with and without
# drops, one token of decode, a T that the shards do not divide.
CASES = [(48, 2, 2.0, 1, False), (64, 2, 1.0, 1, True),
         (96, 2, 0.5, 1, False), (64, 2, 2.0, 4, False),
         (64, 1, 1.0, 4, True), (2, 2, 1.25, 1, False),
         (30, 2, 0.5, 4, False)]


@pytest.mark.parametrize("T,k,cf,shards,skewed", CASES)
def test_moe_apply_matches_jax(params, T, k, cf, shards, skewed):
    jp, tp = params
    x = _tokens(T, seed=T + shards, skewed=skewed)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=k,
                                    capacity_factor=cf, shards=shards)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=k,
                              capacity_factor=cf, shards=shards,
                              shard_axes=("data", "model"))
    assert got.shape == (T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)


def test_moe_apply_drops_as_jax_does(params):
    """At cf 1 with every token on the same two experts, a capacity of 32
    keeps the first 32 tokens' pairs: the rows JAX zeroes are the rows the
    port zeroes (the stable sort ranks pairs in token order), and the kept
    rows are the dense reference's."""
    jp, tp = params
    x = _tokens(64, seed=4, skewed=True)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2,
                             capacity_factor=1.0)
    got, _ = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                            capacity_factor=1.0)
    zero = np.all(np.abs(np.asarray(want)) < 1e-12, axis=1)
    np.testing.assert_array_equal(zero, np.arange(64) >= 32)
    np.testing.assert_array_equal(
        np.all(np.abs(got.numpy()) < 1e-12, axis=1), zero)
    kept = _dense_ref(tp, torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(got.numpy()[:32], kept[:32], atol=ATOL)


def test_moe_apply_bf16_matches_jax():
    """bf16 experts and tokens (the full-width serving dtype); the router
    stays f32."""
    jp = jmoe.moe_init(jax.random.PRNGKey(5), D, FF, E, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = _tokens(40, seed=6)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                    top_k=2, capacity_factor=2.0)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                              top_k=2, capacity_factor=2.0)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)


def test_matches_dense_reference_dropless(params):
    _, tp = params
    x = torch.from_numpy(_tokens(48, seed=1))
    y, aux = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=2.0)
    np.testing.assert_allclose(y.numpy(), _dense_ref(tp, x, 2).numpy(),
                               atol=ATOL)
    assert float(aux) > 0.0


def test_shard_local_dispatch_consistency(params):
    """Dropless, shard-local dispatch equals global dispatch."""
    _, tp = params
    x = torch.from_numpy(_tokens(64, seed=2))
    y1, _ = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=2.0, shards=1)
    y4, _ = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=2.0, shards=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=ATOL)


def test_tiny_batch_dropless_floor(params):
    """Decode batches (T ≤ 16) drop nothing whatever the skew."""
    _, tp = params
    x = torch.from_numpy(_tokens(8, seed=3, skewed=True))
    y, _ = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), _dense_ref(tp, x, 2).numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("T,k,E_,cf", [(1024, 2, 8, 1.25), (2, 2, 4, 1.25),
                                        (100, 1, 100, 1.0),
                                        (4096, 8, 128, 16.0),
                                        (2064, 8, 384, 48.0), (7, 3, 5, 0.3)])
def test_capacity_formula_matches_jax(T, k, E_, cf):
    assert tmoe._capacity(T, k, E_, cf) == jmoe._capacity(T, k, E_, cf)


def test_capacity_formula():
    assert tmoe._capacity(1024, 2, 8, 1.25) == 320
    assert tmoe._capacity(2, 2, 4, 1.25) == 2        # floored at T
    assert tmoe._capacity(100, 1, 100, 1.0) == 16    # floored at min(T, 16)


def test_attention_qk_norm_before_rope_matches_jax():
    """Qwen3's qk_norm: rmsnorm of q and k over the head dim with their own
    (hd,) scales, before RoPE; the self-attention layer's output against
    JAX's with nonzero scales."""
    jcfg = jax_get_config("qwen3-moe-235b-a22b", reduced=True)
    tcfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    jp = jtfm.attn_init(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(8)
    jp = dict(jp, q_norm=jnp.asarray(rng.standard_normal(jcfg.hd),
                                     jnp.float32),
              k_norm=jnp.asarray(rng.standard_normal(jcfg.hd), jnp.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.arange(11)[None, :]
    spec = jcfg.pattern[0]
    want, _ = jtfm.self_attn_apply(jp, jnp.asarray(x), jcfg, spec,
                                   positions=jnp.asarray(pos))
    got, _ = ttfm.self_attn_apply(tp, torch.from_numpy(x), tcfg,
                                  tcfg.pattern[0],
                                  positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the scales reach the scores: without them the output moves
    plain = {k: v for k, v in tp.items() if not k.endswith("_norm")}
    other, _ = ttfm.self_attn_apply(plain, torch.from_numpy(x), tcfg,
                                    tcfg.pattern[0],
                                    positions=torch.from_numpy(pos))
    assert float((other - got).abs().max()) > 1e-3


def test_cross_attention_has_no_qk_norm_or_bias():
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True).replace(
        qkv_bias=True)
    assert set(ttfm.attn_init(None, cfg, "meta")) == {
        "wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm"}
    assert set(ttfm.attn_init(None, cfg, "meta", cross=True)) == {
        "wq", "wk", "wv", "wo"}


def test_moe_init_draws_jax_distributions_a_slice_at_a_time():
    """The expert leaves are N(0, 1/d_in) in the parameter dtype, drawn a
    few experts at a time: every element written, slices not repeated."""
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, 64, 96, 6, torch.bfloat16, "cpu", lead=(2,))
    assert p["router"].shape == (2, 64, 6)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (2, 6, 64, 96)
    assert p["w_down"].shape == (2, 6, 96, 64)
    assert p["w_gate"].dtype == torch.bfloat16
    for name, d_in in (("w_gate", 64), ("w_up", 64), ("w_down", 96)):
        w = p[name].float()
        assert torch.isfinite(w).all()
        assert abs(float(w.std()) * d_in ** 0.5 - 1) < 0.03
    w = normal_init(torch.Generator().manual_seed(1), (5, 3, 4), 2.0,
                    torch.float32, "cpu", slice_elems=12)
    assert not torch.equal(w[0], w[1])
    assert torch.isfinite(w).all() and float(w.abs().min()) > 0.0
