"""The port's bf16 LM path against the JAX package: ``params_from_jax`` on
a bf16 parameter tree, the dense decoder's ``forward``, ``prefill`` and
``greedy_decode`` with the JAX package's serving dtypes (``DTYPE_OVERRIDES``
in ``repro.launch.dryrun``: bf16 parameters and compute), and the bf16
route of ``flash_attention`` on the CPU.  Both packages run JAX's
``init_params`` weights on JAX's tokens, at the reduced widths."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtfm
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.models.inputs import make_batch as jax_make_batch
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as kmod
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import LayerSpec
from repro_torch.training import serve as tserve
from repro_torch.utils import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
# The JAX package's serving dtypes (repro.launch.dryrun.DTYPE_OVERRIDES).
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
PROMPT = 20
WINDOW = 8   # Gemma-2's local window, cut so that it bites at PROMPT
NAMES = ["gemma2-9b", "qwen2.5-3b"]


def _configs(name):
    """The same reduced configuration in both packages, in f32 and in
    bf16; Gemma-2's local layers get a window of 8 tokens."""
    jcfg = jax_get_config(name, reduced=True)
    tcfg = get_config(name, reduced=True)
    if name == "gemma2-9b":
        jcfg = jcfg.replace(pattern=(JaxLayerSpec("attn", WINDOW, "dense"),
                                     JaxLayerSpec("attn", 0, "dense")))
        tcfg = tcfg.replace(pattern=(LayerSpec("attn", WINDOW, "dense"),
                                     LayerSpec("attn", 0, "dense")))
    return jcfg, jcfg.replace(**BF16), tcfg.replace(**BF16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gap(a, b) -> float:
    return float(np.abs(_f32(a) - _f32(b)).max())


# The port's bf16 outputs against JAX's, as a multiple of JAX's own
# bf16-vs-f32 gap.  The model's op scales q in bf16 as JAX's model does,
# so the two differ only where ATen and XLA round products and sums
# otherwise; the largest ratio on these weights is 1.08 (qwen2.5-3b's
# prefill logits, 1.20 when the op scaled q in f32).
GAP_RATIO = 1.5


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(name, JAX f32 cfg, JAX bf16 cfg, port bf16 cfg, JAX f32 params,
    JAX bf16 params, port params, JAX batch, port batch).  JAX's bf16
    weights are its f32 draws rounded (``dense_init`` draws in f32)."""
    jcfg, jcfg16, tcfg16 = _configs(request.param)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    jparams16 = jtfm.init_params(jax.random.PRNGKey(0), jcfg16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams16),
                              device="cpu")
    jbatch = jax_make_batch(jax.random.PRNGKey(1), jcfg, PROMPT, 2,
                            kind="prefill")
    tbatch = {"tokens": torch.as_tensor(np.array(jbatch["tokens"]),
                                        dtype=torch.int64)}
    return (request.param, jcfg, jcfg16, tcfg16, jparams, jparams16,
            tparams, jbatch, tbatch)


def test_params_carry_across_bitwise(model):
    """Every leaf of a bf16 JAX tree keeps its name, shape and dtype (the
    dense weights bf16, the norm scales f32), bit for bit."""
    *_, jparams16, tparams, _, _ = model
    jleaves = jax.tree_util.tree_flatten_with_path(jparams16)[0]
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    dtypes = set()
    for (path, j), t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype.name}", path
        dtypes.add(j.dtype.name)
        if j.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)
    assert dtypes == {"bfloat16", "float32"}


def test_forward_matches_jax_within_twice_its_bf16_gap(model):
    """The port's bf16 logits against JAX's bf16 logits on the same
    weights and tokens, within GAP_RATIO (1.5) times JAX's own
    bf16-vs-f32 gap: both packages round to bf16 after every product, at
    places that differ (ATen's and XLA's matmuls, the exact softmax
    against JAX's chunked one), so they may differ by the size of bf16
    rounding itself."""
    _, jcfg, jcfg16, tcfg16, jparams, jparams16, tparams, jbatch, tbatch = \
        model
    want32, _ = jtfm.forward(jparams, jbatch, jcfg)
    want, _ = jtfm.forward(jparams16, jbatch, jcfg16)
    got, _ = ttfm.forward(tparams, tbatch, tcfg16)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, PROMPT, tcfg16.vocab_size)
    gap = _gap(want, want32)
    assert 0.0 < gap < 0.2 * float(np.abs(_f32(want32)).max())
    assert _gap(got, want) <= GAP_RATIO * gap


def test_prefill_matches_jax_within_twice_its_bf16_gap(model):
    """The last position's logits and every cache leaf (k, v of every
    layer), each within GAP_RATIO (1.5) times JAX's own bf16-vs-f32 gap
    on that output."""
    _, jcfg, jcfg16, tcfg16, jparams, jparams16, tparams, jbatch, tbatch = \
        model
    want32_logits, want32_caches = jtfm.prefill(jparams, jbatch, jcfg)
    want_logits, want_caches = jtfm.prefill(jparams16, jbatch, jcfg16)
    got_logits, got_caches = ttfm.prefill(tparams, tbatch, tcfg16)
    assert got_logits.dtype == torch.bfloat16
    assert _gap(got_logits, want_logits) <= GAP_RATIO * _gap(
        want_logits, want32_logits)
    got, want = tree_leaves(got_caches), jax.tree.leaves(want_caches)
    want32 = jax.tree.leaves(want32_caches)
    assert len(got) == len(want) == 2 * len(tcfg16.pattern)
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        assert _gap(g, w) <= GAP_RATIO * _gap(w, w32)


def test_greedy_decode_runs_in_bf16(model):
    """Prefill then 8 greedy tokens in bf16 on the CPU: valid tokens,
    finite bf16 logits, and the decoded last logits against ``forward``
    over the prompt and the decoded tokens within JAX's own bf16-vs-f32
    gap.  The two paths compute the same function but round it to bf16
    at other places (decode reads k and v back from the bf16 cache and
    merges the new token through the softmax statistics), so they differ
    by bf16 rounding noise, not by the 5e-3 that holds f32 decode to f32
    forward."""
    _, jcfg, jcfg16, tcfg16, jparams, jparams16, tparams, jbatch, tbatch = \
        model
    tokens, logits = tserve.greedy_decode(tparams, tbatch, tcfg16, 8)
    assert tokens.shape == (2, 8) and logits.shape == (2, 1,
                                                       tcfg16.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert 0 <= int(tokens.min()) <= int(tokens.max()) < tcfg16.vocab_size
    full = {"tokens": torch.cat([tbatch["tokens"], tokens], dim=1)}
    want, _ = ttfm.forward(tparams, full, tcfg16)
    want32, _ = jtfm.forward(jparams, jbatch, jcfg)
    want16, _ = jtfm.forward(jparams16, jbatch, jcfg16)
    assert _gap(logits[:, 0], want[:, -1]) <= _gap(want16, want32)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", [
    (1, 2, 1, 100, 32, 0, 0.0),
    (2, 6, 2, 70, 64, 16, 50.0),
    (1, 4, 2, 40, 256, 0, 50.0),
])
def test_flash_attention_bf16_on_the_cpu_runs_the_plain_version(
        B, H, KV, S, D, window, cap):
    """A bf16 CPU tensor takes the plain version, bit for bit, and
    launches neither kernel."""
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, n, S, D)),
                               dtype=torch.float32).to(torch.bfloat16)
               for n in (H, KV, KV))
    before = (kmod.launches, kmod.launches_bf16)
    mode = {"causal": True, "window": window, "cap": cap}
    got = kmod.flash_attention(q, k, v, **mode)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, flash_attention_ref(q, k, v, **mode))
    assert (kmod.launches, kmod.launches_bf16) == before


def test_flash_attention_lists_both_sources():
    """The f32 and the bf16 kernels, each in its own source, and both in
    the tuple the build reads; both run their products on the tensor
    cores (wgmma fed by TMA): the f32 kernel with TF32 operands at every
    head dim (no ``mma.sync`` fallback), the bf16 kernel issuing the P_lo
    product beside P_hi's."""
    assert kmod.SOURCES == (kmod.SOURCE_F32, kmod.SOURCE_BF16)
    assert [s.name for s in kmod.SOURCES] == ["flash_attention.cu",
                                              "flash_attention_sm90.cu"]
    for source in kmod.SOURCES:
        assert source.is_file()
    f32 = kmod.SOURCE_F32.read_text()
    sm90 = kmod.SOURCE_BF16.read_text()
    for text in (f32, sm90):
        assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
        assert "fmaf" not in text            # no product on the CUDA cores
    assert "f32.tf32.tf32" in f32 and "mma.sync" not in f32
    assert "bfloat16" not in f32
    assert "wgmma_rs<DP>(acc, pa," in sm90 and "wgmma_rs<DP>(acc, pl," in sm90


def test_importing_the_kernels_needs_no_nvcc():
    """Importing the wrapper (and the model that calls it) builds
    nothing and starts no compiler: a fresh interpreter with no ``nvcc``
    on its PATH, and every process start refused, imports them and
    runs the CPU route."""
    code = "\n".join([
        "import subprocess",
        "def refuse(*a, **k):",
        "    raise AssertionError('a process was started: %r' % (a,))",
        "subprocess.Popen = subprocess.run = refuse",
        "import torch",
        "from repro_torch.kernels import flash_attention as fa",
        "from repro_torch.models import transformer",
        "q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)",
        "k = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)",
        "fa.flash_attention(q, k, k)",
        "assert fa._library.cache_info().currsize == 0",
        "assert (fa.launches, fa.launches_bf16) == (0, 0)",
        "print('ok')",
    ])
    env = dict(os.environ, PATH="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
