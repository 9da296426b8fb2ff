"""The port's xLSTM mixers (`repro_torch.models.xlstm`) against the JAX
package on identical numpy inputs and JAX's init weights: the chunkwise
mLSTM cell with and without a carried state, its single-token step, the
mLSTM block with its cache (one token through the step, more through the
cell), the sLSTM step and block with their caches; and the JAX package's
own ``tests/test_recurrent_cells.py`` checks run on the port (the
chunkwise cell against the recurrence, chunk-size invariance, streaming).

Tolerances: against JAX, 1e-5 of the largest magnitude (the same f32
arithmetic, sums in other orders); the port against itself in another
form (chunkwise against step by step, other chunk sizes), JAX's own
2e-4 absolute and 2e-3 relative (1e-5 absolute for the sLSTM's
streaming, which repeats the same steps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import LayerSpec as JaxLayerSpec
from repro_torch.convert import params_from_jax
from repro_torch.models import xlstm as tx
from repro_torch.models.config import ArchConfig, LayerSpec

REL = 1e-5
CELL = {"atol": 2e-4, "rtol": 2e-3}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _close_rel(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def _cfgs(mixer, heads, chunk=8):
    kw = dict(name="t", arch_type="ssm", num_layers=1, d_model=32,
              num_heads=heads, num_kv_heads=heads, d_ff=0, vocab_size=64,
              mlstm_chunk=chunk)
    return (JaxArchConfig(pattern=(JaxLayerSpec(mixer, 0, "none"),), **kw),
            ArchConfig(pattern=(LayerSpec(mixer, 0, "none"),), **kw))


def _cell_inputs(B, S, nh, dh, seed, f_shift=2.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, nh, dh)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.standard_normal((B, S, nh)).astype(np.float32)
    f_raw = (rng.standard_normal((B, S, nh)) + f_shift).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _state(B, nh, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nh, dh, dh)).astype(np.float32),
            rng.standard_normal((B, nh, dh)).astype(np.float32),
            rng.standard_normal((B, nh)).astype(np.float32))


@pytest.mark.parametrize("S,chunk,with_state", [(37, 8, False),
                                                (37, 8, True),
                                                (16, 16, True),
                                                (5, 8, False)])
def test_mlstm_cell_matches_jax(S, chunk, with_state):
    args = _cell_inputs(2, S, 3, 8, seed=S + chunk)
    st = _state(2, 3, 8, seed=S) if with_state else None
    want_h, want_st = jx.mlstm_cell(*map(jnp.asarray, args), chunk=chunk,
                                    state=None if st is None else tuple(
                                        map(jnp.asarray, st)))
    got_h, got_st = tx.mlstm_cell(*map(torch.from_numpy, args), chunk=chunk,
                                  state=None if st is None else tuple(
                                      map(torch.from_numpy, st)))
    _close_rel(got_h, want_h)
    for g, w in zip(got_st, want_st):
        _close_rel(g, w)


def test_mlstm_step_matches_jax():
    q, k, v, i_raw, f_raw = _cell_inputs(2, 1, 3, 8, seed=9)
    st = _state(2, 3, 8, seed=10)
    args = (q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
    want_h, want_st = jx.mlstm_step(*map(jnp.asarray, args),
                                    tuple(map(jnp.asarray, st)))
    got_h, got_st = tx.mlstm_step(*map(torch.from_numpy, args),
                                  tuple(map(torch.from_numpy, st)))
    _close_rel(got_h, want_h)
    for g, w in zip(got_st, want_st):
        _close_rel(g, w)


def test_mlstm_chunkwise_equals_recurrence():
    B, S, nh, dh = 2, 37, 3, 8
    args = [torch.from_numpy(a) for a in _cell_inputs(B, S, nh, dh, seed=0)]
    h_chunk, state_chunk = tx.mlstm_cell(*args, chunk=8)
    q, k, v, i_raw, f_raw = args
    state = (torch.zeros(B, nh, dh, dh), torch.zeros(B, nh, dh),
             torch.full((B, nh), -1e30))
    hs = []
    for t in range(S):
        h_t, state = tx.mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t],
                                   f_raw[:, t], state)
        hs.append(h_t)
    np.testing.assert_allclose(h_chunk.numpy(),
                               torch.stack(hs, dim=1).numpy(), **CELL)
    np.testing.assert_allclose(state_chunk[0].numpy(), state[0].numpy(),
                               **CELL)


def test_mlstm_chunk_size_invariance():
    args = [torch.from_numpy(a)
            for a in _cell_inputs(1, 64, 2, 16, seed=1, f_shift=1.0)]
    h8, _ = tx.mlstm_cell(*args, chunk=8)
    h64, _ = tx.mlstm_cell(*args, chunk=64)
    h13, _ = tx.mlstm_cell(*args, chunk=13)       # ragged chunks
    np.testing.assert_allclose(h8.numpy(), h64.numpy(), **CELL)
    np.testing.assert_allclose(h13.numpy(), h64.numpy(), **CELL)


def test_mlstm_apply_with_its_cache_matches_jax():
    """16 tokens without a cache, then one (the step) and then three (the
    cell with a state), each from the last call's cache."""
    jcfg, tcfg = _cfgs("mlstm", 2)
    jp = jx.mlstm_init(jax.random.PRNGKey(0), 32, 2, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 20, 32)).astype(
        np.float32)
    jcache = tcache = None
    for part in (slice(0, 16), slice(16, 17), slice(17, 20)):
        want, jcache = jx.mlstm_apply(jp, jnp.asarray(x[:, part]), jcfg,
                                      jcache)
        got, tcache = tx.mlstm_apply(tp, torch.from_numpy(x[:, part]), tcfg,
                                     tcache)
        _close_rel(got, want)
        assert sorted(tcache) == sorted(jcache) == ["C", "conv", "m", "n"]
        for name in jcache:
            _close_rel(tcache[name], jcache[name])


def test_mlstm_block_streaming_consistency():
    _, tcfg = _cfgs("mlstm", 2)
    tp = tx.mlstm_init(torch.Generator().manual_seed(0), 32, 2,
                       torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, 32)).astype(np.float32))
    y_full, _ = tx.mlstm_apply(tp, x, tcfg)
    y1, cache = tx.mlstm_apply(tp, x[:, :16], tcfg)
    y2, _ = tx.mlstm_apply(tp, x[:, 16:17], tcfg, cache=cache)
    np.testing.assert_allclose(y_full[:, :16].numpy(), y1.numpy(), **CELL)
    np.testing.assert_allclose(y_full[:, 16].numpy(), y2[:, 0].numpy(),
                               **CELL)


def test_slstm_step_matches_jax():
    jp = jx.slstm_init(jax.random.PRNGKey(2), 32, 4, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    xw = rng.standard_normal((2, 128)).astype(np.float32)
    st = tuple(rng.standard_normal((2, 32)).astype(np.float32)
               for _ in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    want_h, want_st = jx.slstm_step(jp, jnp.asarray(xw),
                                    tuple(map(jnp.asarray, st)), 4)
    got_h, got_st = tx.slstm_step(tp, torch.from_numpy(xw),
                                  tuple(map(torch.from_numpy, st)), 4)
    _close_rel(got_h, want_h)
    for g, w in zip(got_st, want_st):
        _close_rel(g, w)


def test_slstm_apply_with_its_cache_matches_jax():
    jcfg, tcfg = _cfgs("slstm", 4)
    jp = jx.slstm_init(jax.random.PRNGKey(4), 32, 4, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 24, 32)).astype(
        np.float32)
    jcache = tcache = None
    for part in (slice(0, 11), slice(11, 12), slice(12, 24)):
        want, jcache = jx.slstm_apply(jp, jnp.asarray(x[:, part]), jcfg,
                                      jcache)
        got, tcache = tx.slstm_apply(tp, torch.from_numpy(x[:, part]), tcfg,
                                     tcache)
        _close_rel(got, want)
        for name in ("c", "n", "m", "h"):
            _close_rel(tcache[name], jcache[name])


def test_slstm_streaming_consistency():
    _, tcfg = _cfgs("slstm", 4)
    tp = tx.slstm_init(torch.Generator().manual_seed(0), 32, 4,
                       torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, 32)).astype(np.float32))
    y_full, _ = tx.slstm_apply(tp, x, tcfg)
    y1, cache = tx.slstm_apply(tp, x[:, :11], tcfg)
    y2, _ = tx.slstm_apply(tp, x[:, 11:], tcfg, cache=cache)
    np.testing.assert_allclose(y_full[:, :11].numpy(), y1.numpy(), atol=1e-5)
    np.testing.assert_allclose(y_full[:, 11:].numpy(), y2.numpy(), atol=1e-5)


def test_xlstm_init_shapes_and_biases():
    """JAX's leaf shapes and dtypes, the forget-gate biases (3 + head
    index for the mLSTM, 3 for the sLSTM), with stacked periods."""
    g = torch.Generator().manual_seed(0)
    m = tx.mlstm_init(g, 32, 2, torch.bfloat16, "cpu", lead=(3,))
    jm = jax.eval_shape(lambda k: jx.mlstm_init(k, 32, 2, jnp.bfloat16),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    for name, leaf in jm.items():
        assert tuple(m[name].shape) == (3,) + leaf.shape, name
        assert str(m[name].dtype)[6:] == str(leaf.dtype), name
    np.testing.assert_array_equal(m["b_gates"][2].numpy(), [0, 0, 3, 4])
    s = tx.slstm_init(g, 32, 4, torch.float32, "cpu")
    js = jax.eval_shape(lambda k: jx.slstm_init(k, 32, 4, jnp.float32),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert {n: tuple(v.shape) for n, v in s.items()} == \
        {n: v.shape for n, v in js.items()}
    np.testing.assert_array_equal(s["b_in"][64:96].numpy(), np.full(32, 3.0))
