"""Attention's gradient in the port against the JAX package on identical
numpy inputs: ``flash_attention`` (kernel layout) against ``jax.grad`` of
JAX's oracle, ``flash_attention_op`` (model layout) against ``jax.grad``
of the model's chunked attention, which is what the JAX package trains
through.  On the CPU the port's route is the plain forward and the plain
backward (`flash_attention_bwd_ref`) through ``FlashAttentionFn``; the
plain backward is also held against torch's autograd through the plain
forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_fa_ref
from repro.models.attention import flash_attention as jax_model_fa
from repro_torch.kernels import flash_attention as kmod
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

# Each gradient's largest error over its largest magnitude.  f32: two f32
# computations of one function, their sums in other orders.  bf16: the
# gradients are rounded to bf16 (2^-8 of the value) and the port's Δ
# reads the bf16 output where JAX's AD reads the f32 one.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODES = {"causal": {"causal": True},
         "window": {"causal": True, "window": 5},
         "cap": {"causal": True, "cap": 2.0}}
CASES = [(dtype, G, D, mode)
         for dtype in ("float32", "bfloat16")
         for G, D in ((1, 32), (2, 256), (4, 32))
         for mode in MODES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) \
        else np.asarray(got.astype(jnp.float32))
    want = np.asarray(want.astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(shapes, dtype, seed):
    """numpy draws rounded once to ``dtype`` in both packages; q has a
    spread of 2 so the softmax is neither flat nor one-hot."""
    rng = np.random.default_rng(seed)
    arrs = [(2.0 if i == 0 else 1.0) * rng.standard_normal(s)
            .astype(np.float32) for i, s in enumerate(shapes)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _port_grads(fn, tq, tk, tv, tdo):
    q, k, v = (x.clone().requires_grad_() for x in (tq, tk, tv))
    out = fn(q, k, v)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, (q, k, v), tdo)


def _jax_grads(fn, jq, jk, jv, jdo):
    out, vjp = jax.vjp(fn, jq, jk, jv)
    return out, vjp(jdo)


@pytest.mark.parametrize("dtype,G,D,mode", CASES)
def test_kernel_layout_grads_match_jax_oracle(dtype, G, D, mode):
    """(B, H, S, D): S = 37, no multiple of any block."""
    B, KV, S = 2, 2, 37
    H = KV * G
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        [(B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D)], dtype,
        seed=G * 1000 + D)
    kw = MODES[mode]
    before = (kmod.launches, kmod.launches_bf16, kmod.launches_bwd,
              kmod.launches_bwd_bf16)
    out, grads = _port_grads(lambda q, k, v: kmod.flash_attention(
        q, k, v, **kw), tq, tk, tv, tdo)
    jout, jgrads = _jax_grads(lambda q, k, v: jax_fa_ref(q, k, v, **kw),
                              jq, jk, jv, jdo)
    assert out.dtype == tq.dtype
    assert _rel(out, jout) <= GRAD_TOL[dtype]
    for got, want in zip(grads, jgrads):
        assert got.dtype == tq.dtype and got.shape == want.shape
        assert _rel(got, want) <= GRAD_TOL[dtype]
    assert (kmod.launches, kmod.launches_bf16, kmod.launches_bwd,
            kmod.launches_bwd_bf16) == before   # the CPU launches nothing


@pytest.mark.parametrize("dtype,G,D,mode", CASES)
def test_model_layout_grads_match_jax_model_attention(dtype, G, D, mode):
    """(B, S, H, D) through ``flash_attention_op`` (q scaled in its own
    dtype, as JAX's model does) against ``jax.vjp`` of the model's chunked
    attention, blocks of 16 over S = 37."""
    B, KV, S = 2, 2, 37
    H = KV * G
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        [(B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)], dtype,
        seed=G * 2000 + D)
    kw = MODES[mode]
    out, grads = _port_grads(lambda q, k, v: flash_attention_op(
        q, k, v, **kw), tq, tk, tv, tdo)
    jout, jgrads = _jax_grads(lambda q, k, v: jax_model_fa(
        q, k, v, block=16, **kw), jq, jk, jv, jdo)
    assert _rel(out, jout) <= GRAD_TOL[dtype]
    for got, want in zip(grads, jgrads):
        assert got.dtype == tq.dtype
        assert _rel(got, want) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_grads_through_the_head_dim_pad(dtype):
    """Kimi K2's D = 112 (G = 8), which the op zero-pads to 128 for the
    kernels and slices back: the gradients flow through the pad and the
    slice, against ``jax.vjp`` of the model's attention at D = 112."""
    B, KV, S, D = 1, 1, 37, 112
    H = 8 * KV
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        [(B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)], dtype,
        seed=112)
    out, grads = _port_grads(flash_attention_op, tq, tk, tv, tdo)
    jout, jgrads = _jax_grads(lambda q, k, v: jax_model_fa(
        q, k, v, block=16), jq, jk, jv, jdo)
    assert _rel(out, jout) <= GRAD_TOL[dtype]
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape and got.dtype == tq.dtype
        assert _rel(got, want) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("G,D,kw", [
    (1, 32, {"causal": True}),
    (2, 64, {"causal": True, "window": 4, "cap": 3.0}),
    (4, 32, {"causal": False}),
    (2, 32, {"causal": True, "scale": 1.0}),
])
def test_plain_backward_matches_autograd_through_plain_forward(G, D, kw):
    """`flash_attention_bwd_ref` from the row statistics against torch's
    autograd through `flash_attention_ref`, f32, Sq ≠ Skv included."""
    rng = np.random.default_rng(G + D)
    B, KV, Sq, Skv = 2, 2, 19, 23 if not kw.get("causal") else 19
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for s in (
        (B, KV * G, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D),
        (B, KV * G, Sq, D)))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = flash_attention_ref(qg, kg, vg, return_lse=True, **kw)
    want = torch.autograd.grad(o, (qg, kg, vg), do)
    got = flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                  **kw)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


def test_flash_attention_op_is_differentiable_on_the_cpu():
    """The model-layout op with q.requires_grad: a gradient through the
    Function (its forward used to write q·D^-0.5 with ``out=``, which
    autograd refuses)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 32))
                         .astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    out = flash_attention_op(q, k, v)
    nodes, seen = [out.grad_fn], []
    while nodes:
        node = nodes.pop()
        seen.append(type(node).__name__)
        nodes += [n for n, _ in node.next_functions if n is not None]
    assert any("FlashAttentionFn" in name for name in seen)
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert g.shape == q.shape and bool(torch.isfinite(g).all())


def test_no_grad_forward_is_the_plain_version_bitwise():
    """Without grad the wrapper's CPU route is `flash_attention_ref`, bit
    for bit (the serve path), and its output carries no graph."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 11, 64), (1, 2, 11, 64), (1, 2, 11, 64)))
    got = kmod.flash_attention(q, k, v, window=3, cap=5.0)
    assert got.grad_fn is None
    assert torch.equal(got, flash_attention_ref(q, k, v, window=3, cap=5.0))


def test_grad_off_the_cpu_never_takes_the_plain_route():
    """A tensor neither on the CPU nor on CUDA (here ``meta``) raises in
    the Function as in the forward: the wrapper has no fallback to
    autograd through the plain version."""
    q = torch.empty((1, 2, 8, 32), device="meta", requires_grad=True)
    k = torch.empty((1, 1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        kmod.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        kmod.flash_attention_bwd(q.detach(), k, k, q.detach(),
                                 torch.empty((1, 2, 8), device="meta"),
                                 q.detach())
