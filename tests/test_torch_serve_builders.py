"""The serving builders of `repro_torch.training.dist_steps` against JAX's
on a one-device CPU mesh, and ``examples/serve_decode_torch.py`` against
``examples/serve_decode.py``: ``make_prefill_step``, ``make_decode_step``
with ``window_override`` (the long_500k sliding-window variant) and
``replicate_cache_heads`` (a mesh layout: one card holds the whole cache,
so the step is the default step), on JAX's weights, prompts and caches
carried across, at the reduced widths.  f32 end to end; the sums run in
other orders (test_torch_lm.py's ATOL)."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jtfm
from repro.models.config import InputShape as JaxInputShape
from repro.models.inputs import make_batch as jax_make_batch
from repro.training import dist_steps as jds
from repro.training import serve as jserve
from repro_torch.convert import params_from_jax
from repro_torch.models.config import InputShape
from repro_torch.training import dist_steps as tds
from repro_torch.training import serve as tserve
from repro_torch.utils import tree_leaves
from test_torch_lm import ATOL, _batch, _configs

ROOT = Path(__file__).resolve().parents[1]
PROMPT, NEW = 20, 6
CACHE = PROMPT + NEW


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(name):
    jcfg, tcfg = _configs(name)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jbatch = jax_make_batch(jax.random.PRNGKey(1), jcfg, PROMPT, 2,
                            kind="prefill")
    return jcfg, tcfg, jparams, tparams, jbatch, _batch(jbatch)


def _close(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=ATOL)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "phi4-mini-3.8b",
                                  "whisper-tiny", "internvl2-2b"])
def test_prefill_step_matches_jax(name):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _model(name)
    jshape = JaxInputShape("p", PROMPT, 2, "prefill")
    jstep, _, _, _ = jds.make_prefill_step(jcfg, jshape,
                                           make_local_mesh(1, 1))
    tstep = tds.make_prefill_step(tcfg, InputShape("p", PROMPT, 2,
                                                   "prefill"))
    jlogits, jcaches = jstep(jparams, jbatch)
    tlogits, tcaches = tstep(tparams, tbatch)
    _close(tlogits, jlogits)
    _close(tcaches, jcaches)


@pytest.mark.parametrize("name,window", [
    ("qwen2.5-3b", None), ("qwen2.5-3b", 8), ("gemma2-9b", 4),
    ("phi4-mini-3.8b", 8), ("llama3-405b", 8)])
@pytest.mark.parametrize("replicate", [False, True])
def test_decode_step_matches_jax(name, window, replicate):
    """One decode step against a cache of CACHE positions laid out for the
    step's windowed configuration (JAX's prefill, pad_caches and decode
    step): logits and the k, v deltas.  Gemma-2's local layers keep the
    smaller of their window (8 here) and the override."""
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _model(name)
    jshape = JaxInputShape("d", CACHE, 2, "decode")
    jstep, jargs, _ = jds.make_decode_step(
        jcfg, jshape, make_local_mesh(1, 1), window_override=window,
        replicate_cache_heads=replicate)
    tstep = tds.make_decode_step(tcfg, InputShape("d", CACHE, 2, "decode"),
                                 window_override=window,
                                 replicate_cache_heads=replicate)
    want_windows = [s.window for s in tstep.cfg.pattern]
    if window:
        assert want_windows == [min(s.window, window) or window
                                for s in tcfg.pattern]
    else:
        assert tstep.cfg is tcfg
    _, jcaches = jtfm.prefill(jparams, jbatch, jcfg)
    jrun = jcfg.replace(pattern=tuple(
        type(s)(mixer=s.mixer, window=w, ffn=s.ffn)
        for s, w in zip(jcfg.pattern, want_windows)))
    jcaches = jserve.pad_caches(jcaches, jrun, CACHE, PROMPT)
    # The cache the builder sizes for the step is the one laid out here.
    assert [x.shape for x in jax.tree.leaves(jcaches)] == [
        x.shape for x in jax.tree.leaves(jargs[2])]
    token = jnp.full((2, 1), 7, jnp.int32)
    jlogits, jdeltas = jstep(jparams, token, jcaches,
                             jnp.asarray(PROMPT, jnp.int32))
    tlogits, tdeltas = tstep(tparams, torch.full((2, 1), 7), params_from_jax(
        jax.tree.map(np.asarray, jcaches), device="cpu"), PROMPT)
    _close(tlogits, jlogits)
    _close(tdeltas, jdeltas)


def test_replicate_cache_heads_is_the_default_step_on_one_card():
    """On one card the cache is whole on the device already: the step with
    ``replicate_cache_heads`` returns the default step's bits."""
    _, tcfg, _, tparams, _, tbatch = _model("qwen2.5-3b")
    shape = InputShape("d", CACHE, 2, "decode")
    _, caches = tds.make_prefill_step(tcfg, shape)(tparams, tbatch)
    caches = tserve.pad_caches(caches, tcfg, CACHE, PROMPT)
    token = torch.full((2, 1), 3)
    outs = [tds.make_decode_step(tcfg, shape, replicate_cache_heads=r)(
        tparams, token, caches, PROMPT) for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


def _twin():
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    return twin


@pytest.mark.parametrize("name", ["qwen2.5-3b", "whisper-tiny"])
def test_serve_twin_matches_the_jax_example(name):
    """The twin's decoding loop (the builders' steps) on the JAX example's
    weights (``init_params(PRNGKey(0))``) and prompt (``make_batch(
    PRNGKey(1))``) decodes the example's tokens (``greedy_decode``), and
    its last logits agree."""
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _model(name)
    want_t, want_l = jserve.greedy_decode(jparams, jbatch, jcfg, NEW)
    got_t, got_l = _twin().serve(tparams, tbatch, tcfg, NEW)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    _close(got_l, want_l)


def test_serve_twin_window_matches_jax_decode_loop():
    """The twin with ``window`` 8 on the reduced Qwen2.5-3B (every layer
    full attention, so the window bites at a 20-token prompt) against
    the same loop in JAX: its prefill, pad_caches of the windowed
    configuration, its decode step with ``window_override=8`` and
    apply_cache_deltas."""
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _model("qwen2.5-3b")
    jstep, _, _ = jds.make_decode_step(
        jcfg, JaxInputShape("d", CACHE, 2, "decode"), make_local_mesh(1, 1),
        window_override=8)
    jrun = jcfg.replace(pattern=tuple(type(s)(mixer=s.mixer, window=8,
                                              ffn=s.ffn)
                                      for s in jcfg.pattern))
    logits, caches = jtfm.prefill(jparams, jbatch, jcfg)
    caches = jserve.pad_caches(caches, jrun, CACHE, PROMPT)
    want = []
    for pos in range(PROMPT, CACHE):
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        logits, deltas = jstep(jparams, nxt, caches,
                               jnp.asarray(pos, jnp.int32))
        caches = jserve.apply_cache_deltas(caches, deltas,
                                           jnp.asarray(pos, jnp.int32), jrun)
        want.append(np.asarray(nxt[:, 0]))
    got_t, got_l = _twin().serve(tparams, tbatch, tcfg, NEW, window=8)
    np.testing.assert_array_equal(got_t.numpy(), np.stack(want, axis=1))
    _close(got_l, logits)
    no_window, _ = _twin().serve(tparams, tbatch, tcfg, NEW)
    assert not torch.equal(no_window, got_t)


def test_serve_twin_main_runs_on_the_cpu(capsys):
    out = _twin().main(["--device", "cpu", "--tokens", "4", "--batch", "2",
                        "--window", "16"])
    assert out["tokens"].shape == (2, 4)
    assert "finite logits" in capsys.readouterr().out
