"""The port's front ends against the JAX package on JAX's reduced weights
and batches: the vision projector (``_frontend_prefix``) and the prefix in
front of the text, the audio encoder (``_encode_audio``, bidirectional
attention), the encoder's cross-attention K/V (``encoder_kv``, from block
``b0``'s period-0 ``xattn``) and the decoder's cross-attention, and the
stub inputs (``text_len``, ``make_batch``).

Tolerance: 1e-5 absolute in f32 (the same arithmetic, sums in other
orders; the plain attention against JAX's chunked online softmax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtfm
from repro.models.inputs import make_batch as jax_make_batch
from repro.models.inputs import text_len as jax_text_len
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.models.inputs import make_batch, text_len

ATOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _setup(name):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port
    batch) of a reduced front-end configuration."""
    jcfg = jax_get_config(name, reduced=True)
    tcfg = get_config(name, reduced=True)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jbatch = jax_make_batch(jax.random.PRNGKey(1), jcfg, 20, 2,
                            kind="prefill")
    tbatch = params_from_jax(jax.tree.map(np.asarray, jbatch), device="cpu")
    tbatch["tokens"] = tbatch["tokens"].to(torch.int64)
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


@pytest.fixture(scope="module")
def vlm():
    return _setup("internvl2-2b")


@pytest.fixture(scope="module")
def audio():
    return _setup("whisper-tiny")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_text_len_matches_jax(name):
    assert name in JAX_ARCH_NAMES
    for reduced in (False, True):
        jcfg = jax_get_config(name, reduced=reduced)
        tcfg = get_config(name, reduced=reduced)
        for seq in (1, 8, 9, 300, 2048):
            assert text_len(tcfg, seq) == jax_text_len(jcfg, seq)


@pytest.mark.parametrize("name,key,length", [
    ("internvl2-2b", "patch_embeds", 256),
    ("whisper-tiny", "frames", 1500)])
def test_make_batch_draws_the_stub_inputs(name, key, length):
    """JAX's keys, shapes and dtypes: the stub's embeddings are unit
    normals in the compute dtype, beside the text tokens."""
    cfg = get_config(name)
    jcfg = jax_get_config(name)
    for kind in ("train", "prefill"):
        got = make_batch(0, cfg.replace(vocab_size=97), 300, 2, kind=kind,
                         device="cpu")
        want = jax.eval_shape(lambda k: jax_make_batch(k, jcfg, 300, 2,
                                                       kind=kind),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
        assert got[key].shape == (2, length, cfg.frontend_dim)
        assert got[key].dtype == cfg.cdtype
    x = make_batch(3, cfg, 300, 2, device="cpu")[key]
    assert abs(float(x.std()) - 1) < 0.05 and abs(float(x.mean())) < 0.05


def test_gelu_is_jaxs_tanh_approximation():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(x)), atol=1e-6)


def test_frontend_prefix_matches_jax(vlm):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = vlm
    want = jtfm._frontend_prefix(jparams, jbatch, jcfg)
    got = ttfm._frontend_prefix(tparams, tbatch, tcfg)
    assert got.shape == (2, tcfg.prefix_tokens, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    # the prefix comes first, then the text's embeddings
    x, enc_kv = ttfm._assemble_inputs(tparams, tbatch, tcfg)
    assert enc_kv is None
    assert x.shape[1] == tcfg.prefix_tokens + tbatch["tokens"].shape[1]
    np.testing.assert_array_equal(_np(x[:, :tcfg.prefix_tokens]), _np(got))
    np.testing.assert_array_equal(
        _np(x[:, tcfg.prefix_tokens:]),
        _np(tparams["embed"][tbatch["tokens"]]))


def test_encode_audio_and_encoder_kv_match_jax(audio):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = audio
    want = jtfm._encode_audio(jparams, jbatch, jcfg)
    got = ttfm._encode_audio(tparams, tbatch, tcfg)
    assert got.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    want_kv = jtfm.encoder_kv(jtfm._first_cross_params(jparams, jcfg),
                              want, jcfg)
    got_kv = ttfm.encoder_kv(ttfm._first_cross_params(tparams, tcfg), got,
                             tcfg)
    for name in ("k", "v"):
        assert got_kv[name].shape == (2, tcfg.encoder_seq,
                                      tcfg.num_kv_heads, tcfg.hd)
        np.testing.assert_allclose(_np(got_kv[name]), _np(want_kv[name]),
                                   atol=ATOL)
    # _assemble_inputs hands the decoder the same K/V
    _, enc_kv = ttfm._assemble_inputs(tparams, tbatch, tcfg)
    np.testing.assert_array_equal(_np(enc_kv["k"]), _np(got_kv["k"]))


@pytest.mark.parametrize("Sq", [5, 1])
def test_cross_attn_apply_matches_jax(audio, Sq):
    """The decoder's cross-attention over JAX's encoder K/V, at a prompt's
    query count and at a decode step's one."""
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = audio
    enc_kv = jtfm.encoder_kv(jtfm._first_cross_params(jparams, jcfg),
                             jtfm._encode_audio(jparams, jbatch, jcfg), jcfg)
    p = jax.tree.map(lambda a: a[1], jparams["layers"]["b0"]["xattn"])
    x = np.random.default_rng(Sq).standard_normal(
        (2, Sq, jcfg.d_model)).astype(np.float32)
    want = jtfm.cross_attn_apply(p, jnp.asarray(x), jcfg, enc_kv)
    got = ttfm.cross_attn_apply(
        params_from_jax(jax.tree.map(np.asarray, p), device="cpu"),
        torch.from_numpy(x), tcfg,
        params_from_jax(jax.tree.map(np.asarray, enc_kv), device="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_self_attn_apply_causal_switch_matches_jax(causal):
    """The encoder's bidirectional self-attention (and the causal one)."""
    jcfg = jax_get_config("whisper-tiny", reduced=True)
    tcfg = get_config("whisper-tiny", reduced=True)
    jp = jtfm.attn_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(13)[None, :]
    want, _ = jtfm.self_attn_apply(jp, jnp.asarray(x), jcfg, jcfg.pattern[0],
                                   positions=jnp.asarray(pos), causal=causal)
    got, _ = ttfm.self_attn_apply(tp, torch.from_numpy(x), tcfg,
                                  tcfg.pattern[0],
                                  positions=torch.from_numpy(pos),
                                  causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


def test_whisper_decoder_blocks_carry_cross_attention():
    """``ln_x`` and ``xattn`` in the decoder's blocks (stacked over its
    periods), none in the encoder's; the encoder has its own input
    projection and final norm."""
    cfg = get_config("whisper-tiny")
    p = ttfm.init_params(0, cfg, device="meta")
    dec = p["layers"]["b0"]
    assert dec["ln_x"].shape == (cfg.num_periods, cfg.d_model)
    assert set(dec["xattn"]) == {"wq", "wk", "wv", "wo"}
    enc = p["encoder"]
    assert enc["in_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert enc["layers"]["b0"]["ln1"].shape == (cfg.encoder_layers,
                                                cfg.d_model)
    assert "xattn" not in enc["layers"]["b0"]
    vlm = ttfm.init_params(0, get_config("internvl2-2b"), device="meta")
    assert vlm["projector"]["w1"].shape == (1024, 2048)
    assert "xattn" not in vlm["layers"]["b0"]
