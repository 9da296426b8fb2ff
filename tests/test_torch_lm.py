"""The port's LM serving slice against the JAX package: every registered
configuration's ``forward`` (logits and the MoE routers' aux loss),
``prefill`` and ``decode_step`` (attention, mamba and xLSTM caches, the
audio encoder's K/V), the serving glue (``pad_caches``,
``apply_cache_deltas``, ``greedy_decode``) and the parameter counts.  Both
packages run JAX's ``init_params`` weights (carried across with
``params_from_jax``) on JAX's batch (tokens, and the front ends' patch
embeddings or audio frames), at the reduced widths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtfm
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.models.inputs import make_batch as jax_make_batch
from repro.training import serve as jserve
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as kmod
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import LayerSpec
from repro_torch.models.inputs import make_batch, text_len
from repro_torch.training import serve as tserve
from repro_torch.training.steps import make_decode_step, make_prefill_step
from repro_torch.utils import tree_leaves

# f32 end to end in both; the sums run in other orders (ATen's matmuls
# against XLA's, exact softmax against JAX's chunked online softmax):
# measured differences are a few 1e-6 on logits of order 1.
ATOL = 1e-4
PROMPT = 20
WINDOW = 8   # Gemma-2's local window, cut so that it bites at PROMPT


def _configs(name):
    """The same reduced configuration in both packages; Gemma-2's local
    layers get a window of 8 tokens."""
    jcfg = jax_get_config(name, reduced=True)
    tcfg = get_config(name, reduced=True)
    if name == "gemma2-9b":
        jcfg = jcfg.replace(pattern=(JaxLayerSpec("attn", WINDOW, "dense"),
                                     JaxLayerSpec("attn", 0, "dense")))
        tcfg = tcfg.replace(pattern=(LayerSpec("attn", WINDOW, "dense"),
                                     LayerSpec("attn", 0, "dense")))
    return jcfg, tcfg


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _batch(jbatch):
    """JAX's batch on the CPU: int64 tokens, the front end's arrays."""
    out = params_from_jax(jax.tree.map(np.asarray, jbatch), device="cpu")
    out["tokens"] = out["tokens"].to(torch.int64)
    return out


def _enc_kv(jparams, jbatch, jcfg):
    """JAX's encoder K/V for the decode steps (audio front end; else
    None), as its ``greedy_decode`` computes them."""
    if jcfg.frontend != "audio_stub":
        return None
    return jtfm.encoder_kv(jtfm._first_cross_params(jparams, jcfg),
                           jtfm._encode_audio(jparams, jbatch, jcfg), jcfg)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def model(request):
    """(name, JAX cfg, port cfg, JAX params, port params, JAX batch, port
    batch) for every configuration the port registers."""
    jcfg, tcfg = _configs(request.param)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jbatch = jax_make_batch(jax.random.PRNGKey(1), jcfg, PROMPT, 2,
                            kind="prefill")
    return request.param, jcfg, tcfg, jparams, tparams, jbatch, \
        _batch(jbatch)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def _trees_close(got, want, atol=ATOL):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, atol)


def test_params_carry_across_leaf_for_leaf(model):
    """``params_from_jax`` keeps every leaf's name, shape and dtype,
    the period axis and ``embed`` included, and the port's own
    ``init_params`` builds the same tree."""
    name, jcfg, tcfg, jparams, tparams, *_ = model
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = tree_leaves(tparams)
    own = tree_leaves(ttfm.init_params(0, tcfg, device="cpu"))
    assert len(jleaves) == len(tleaves) == len(own)
    for (path, j), t, o in zip(jleaves, tleaves, own):
        assert tuple(t.shape) == tuple(o.shape) == j.shape, path
        assert t.dtype == o.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tparams["layers"]["b0"]["ln1"].shape[0] == jcfg.num_periods


def test_forward_matches_jax(model):
    """The logits, and the MoE routers' aux loss summed over the layers
    (0 without MoE)."""
    _, jcfg, tcfg, jparams, tparams, jbatch, tbatch = model
    want, want_aux = jtfm.forward(jparams, jbatch, jcfg)
    got, aux = ttfm.forward(tparams, tbatch, tcfg)
    assert got.shape == (2, PROMPT, tcfg.vocab_size)
    _close(got, want)
    assert aux.shape == () and aux.dtype == torch.float32
    _close(aux, want_aux)
    assert (float(aux) > 0.0) == (tcfg.num_experts > 0)


def test_prefill_matches_jax(model):
    """The last position's logits, and every cache leaf (k, v of every
    layer, stacked over periods)."""
    _, jcfg, tcfg, jparams, tparams, jbatch, tbatch = model
    want_logits, want_caches = jtfm.prefill(jparams, jbatch, jcfg)
    got_logits, got_caches = make_prefill_step(tcfg)(tparams, tbatch)
    _close(got_logits, want_logits)
    _trees_close(got_caches, want_caches)


def test_decode_step_matches_jax(model):
    """One decode step from JAX's own padded caches: logits and the
    deltas of every layer (attention's k, v, Gemma-2's local layers
    through the ring buffer; the recurrent layers' whole states), with
    JAX's encoder K/V for whisper's cross-attention."""
    _, jcfg, tcfg, jparams, tparams, jbatch, _ = model
    _, caches = jtfm.prefill(jparams, jbatch, jcfg)
    caches = jserve.pad_caches(caches, jcfg, PROMPT + 8, PROMPT)
    token = jbatch["tokens"][:, -1:]
    enc_kv = _enc_kv(jparams, jbatch, jcfg)
    want_logits, want_deltas = jtfm.decode_step(
        jparams, token, caches, jnp.asarray(PROMPT, jnp.int32), jcfg,
        enc_kv=enc_kv)
    got_logits, got_deltas = make_decode_step(tcfg)(
        tparams, _t(token, torch.int64),
        params_from_jax(jax.tree.map(np.asarray, caches), device="cpu"),
        PROMPT, enc_kv=(None if enc_kv is None else params_from_jax(
            jax.tree.map(np.asarray, enc_kv), device="cpu")))
    _close(got_logits, want_logits)
    _trees_close(got_deltas, want_deltas)


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen2.5-3b"])
def test_pad_caches_and_cache_writes_match_jax_bitwise(name):
    """From the same prefill caches: the ring order of Gemma-2's local
    layers and the zero padding of its global ones, then one delta
    written at the next position, bitwise."""
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(4)
    periods, B, KV, hd = jcfg.num_periods, 2, jcfg.num_kv_heads, jcfg.hd
    shape = (periods, B, PROMPT, KV, hd)
    caches = {f"b{i}": {"mixer": {
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32)}}
        for i in range(len(jcfg.pattern))}
    deltas = {f"b{i}": {"mixer": {
        "k_new": rng.standard_normal(shape[:2] + (1, KV, hd)).astype(
            np.float32),
        "v_new": rng.standard_normal(shape[:2] + (1, KV, hd)).astype(
            np.float32)}}
        for i in range(len(jcfg.pattern))}
    want = jserve.pad_caches(jax.tree.map(jnp.asarray, caches), jcfg,
                             PROMPT + 8, PROMPT)
    got = tserve.pad_caches(params_from_jax(caches, device="cpu"), tcfg,
                            PROMPT + 8, PROMPT)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jserve.apply_cache_deltas(want, jax.tree.map(jnp.asarray, deltas),
                                     jnp.asarray(PROMPT, jnp.int32), jcfg)
    written = tserve.apply_cache_deltas(
        got, params_from_jax(deltas, device="cpu"), PROMPT, tcfg)
    assert written is got                     # in place
    for g, w in zip(tree_leaves(written), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name == "gemma2-9b":
        assert got["b0"]["mixer"]["k"].shape[2] == WINDOW      # ring
        np.testing.assert_array_equal(tserve._ring_order(PROMPT, WINDOW),
                                      jserve._ring_order(PROMPT, WINDOW))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_greedy_decode_matches_jax(name):
    """Prefill then 8 greedy tokens: identical tokens, and the last
    logits within 1e-4 (the VLM's prompt counts its patch prefix; whisper
    decodes against the encoded audio)."""
    jcfg, tcfg = _configs(name)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jbatch = jax_make_batch(jax.random.PRNGKey(1), jcfg, PROMPT, 2,
                            kind="prefill")
    want_tokens, want_logits = jserve.greedy_decode(jparams, jbatch, jcfg, 8)
    got_tokens, got_logits = tserve.greedy_decode(tparams, _batch(jbatch),
                                                  tcfg, 8)
    np.testing.assert_array_equal(got_tokens.numpy(),
                                  np.asarray(want_tokens))
    _close(got_logits, want_logits)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_forward(name):
    """The port against itself (JAX's ``test_decode_matches_forward``):
    prefill over 16 positions (the VLM's 8 patches among them), one
    decode step of the 17th, against the forward's last logits, within
    JAX's 5e-3."""
    _, cfg = _configs(name)
    params = ttfm.init_params(0, cfg, device="cpu")
    batch = make_batch(1, cfg, 17, 2, kind="prefill", device="cpu")
    full, _ = ttfm.forward(params, batch, cfg)
    prompt = dict(batch, tokens=batch["tokens"][:, :-1])
    _, caches = ttfm.prefill(params, prompt, cfg)
    caches = tserve.pad_caches(caches, cfg, cache_len=20, prompt_len=16)
    enc_kv = None
    if cfg.frontend == "audio_stub":
        enc_kv = ttfm.encoder_kv(ttfm._first_cross_params(params, cfg),
                                 ttfm._encode_audio(params, batch, cfg), cfg)
    dec, deltas = ttfm.decode_step(params, batch["tokens"][:, -1:], caches,
                                   16, cfg, enc_kv=enc_kv)
    err = float((full[:, -1] - dec[:, 0]).abs().max())
    assert err < 5e-3, f"{name}: decode diverges from forward by {err}"
    assert deltas is not None


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_matches_jax(name):
    """From the shapes alone: the port on the ``meta`` device, JAX with
    ``eval_shape``; nothing is allocated at full width."""
    assert ttfm.count_params(get_config(name)) == \
        jtfm.count_params(jax_get_config(name))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_active_params_matches_jax(name):
    """Parameters a token uses (MoE experts at top_k / num_experts), at
    full width from the shapes alone."""
    assert ttfm.count_active_params(get_config(name)) == \
        jtfm.count_active_params(jax_get_config(name))


def test_gemma2_9b_has_its_published_parameter_count():
    assert ttfm.count_params(get_config("gemma2-9b")) == 9_241_404_928


def test_init_params_draws_jax_distributions():
    """Not JAX's draws, but its distributions: embed N(0,1)·d^-0.5, dense
    N(0,1)/√d_in, norm scales 0, on the device asked for."""
    cfg = get_config("gemma2-9b", reduced=True)
    p = ttfm.init_params(3, cfg, device="cpu")
    d = cfg.d_model
    assert abs(float(p["embed"].std()) / d ** -0.5 - 1) < 0.02
    wq = p["layers"]["b0"]["attn"]["wq"]
    assert abs(float(wq.std()) * d ** 0.5 - 1) < 0.02
    w_down = p["layers"]["b1"]["ffn"]["w_down"]
    assert abs(float(w_down.std()) * cfg.d_ff ** 0.5 - 1) < 0.02
    assert float(p["final_norm"].abs().max()) == 0.0
    assert float(p["layers"]["b0"]["ln1"].abs().max()) == 0.0
    again = ttfm.init_params(3, cfg, device="cpu")
    np.testing.assert_array_equal(p["embed"].numpy(),
                                  again["embed"].numpy())


def test_make_batch():
    cfg = get_config("qwen2.5-3b", reduced=True)
    train = make_batch(0, cfg, 12, 3, device="cpu")
    serve = make_batch(0, cfg, 12, 3, kind="prefill", device="cpu")
    assert set(train) == {"tokens", "labels"} and set(serve) == {"tokens"}
    assert train["tokens"].shape == (3, 12)
    assert train["tokens"].dtype == torch.int64
    assert 0 <= int(train["tokens"].min()) <= int(train["tokens"].max()) \
        < cfg.vocab_size
    np.testing.assert_array_equal(train["tokens"].numpy(),
                                  serve["tokens"].numpy())
    assert text_len(cfg, 12) == 12


def test_the_cpu_route_launches_no_kernel():
    """On CPU tensors the attention of prefill runs the plain version."""
    cfg = get_config("gemma2-9b", reduced=True)
    params = ttfm.init_params(0, cfg, device="cpu")
    before = kmod.launches
    ttfm.prefill(params, make_batch(0, cfg, 9, 1, kind="prefill",
                                    device="cpu"), cfg)
    assert kmod.launches == before


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    cfg = get_config("qwen2.5-3b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(0, cfg, 4, 1)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configuration_matches_jax_field_for_field(name):
    """Every registered configuration, the two dense ones the port
    registered last (phi4-mini-3.8b, llama3-405b) among them, published
    and reduced: JAX's fields, and JAX's names."""
    import dataclasses

    from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES

    assert sorted(ARCH_NAMES) == sorted(JAX_ARCH_NAMES)
    for reduced in (False, True):
        got = dataclasses.asdict(get_config(name, reduced=reduced))
        want = dataclasses.asdict(jax_get_config(name, reduced=reduced))
        assert got == want, name


def test_unknown_mixer_is_a_value_error():
    """As in JAX's ``block_init``."""
    cfg = get_config("qwen2.5-3b", reduced=True).replace(
        pattern=(LayerSpec("rwkv", 0, "dense"),))
    with pytest.raises(ValueError, match="unknown mixer"):
        ttfm.init_params(0, cfg, device="cpu")


def test_unknown_configuration_is_a_key_error():
    with pytest.raises(KeyError):
        get_config("gpt-17")
