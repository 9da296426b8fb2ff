"""The port's LM training path against the JAX package, on JAX's weights,
tokens, plans and noise carried across: the model's gradient (the
reduced Gemma-2 and Qwen2.5), the single-model train step, the
shard-mode CWFL step (microbatches, the accumulator's dtype, the channel
noise), the replica-mode step (local SGD, then Algorithm 1 through the
fused round), ``auto_microbatches``, and
``examples/train_lm_cwfl_torch.py`` against ``examples/train_lm_cwfl.py``'s
loop.  Attention's gradient runs through the plain backward on the CPU
(`repro_torch.kernels.flash_attention.FlashAttentionFn`)."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cwfl as jcwfl
from repro.dist.fl_integration import make_fl_plan as jax_make_fl_plan
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jtfm
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.config import InputShape as JaxInputShape
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.optim import sgd as jax_sgd
from repro.training import dist_steps as jds
from repro.training import steps as jsteps
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import (cwfl_state_from_arrays, fl_plan_from_arrays,
                                 params_from_jax)
from repro_torch.core import cwfl as tcwfl
from repro_torch.models.config import INPUT_SHAPES, InputShape, LayerSpec
from repro_torch.optim import sgd
from repro_torch.training import dist_steps as tds
from repro_torch.training import steps as tsteps
from repro_torch.utils.pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
# f32 end to end in both; sums in other orders (ATen's matmuls against
# XLA's, exact softmax and its plain backward against JAX's AD of the
# chunked online softmax): each leaf's largest error over its largest
# magnitude.
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
# A bf16 accumulator: the summed gradients are rounded to bf16, so an f32
# difference of one bf16 ulp (2^-8 of the value) may flip; the update is
# lr times that.
BF16_PARAM_ATOL = 1e-3
# xlstm-125m's reduced f32 gradient is ill-conditioned at this batch: a
# 1e-7 relative change of the params moves it by 9.3e-4 (each leaf's
# largest change over its largest magnitude, the worst leaf); JAX's f32
# gradient lies 9.3e-4 from the port's evaluated in float64, and 2.3e-4
# from JAX's own with mlstm_chunk 8 for 32 (the same function), the
# port's f32 gradient 4.2e-4 and 2.9e-6.  No f32 evaluation meets
# GRAD_RTOL there, and two SGD steps at lr 0.1 carry the gap into the
# second loss (1.6e-3 apart).  Its gradient is held to XLSTM_GRAD_RTOL
# against JAX's, and to GRAD_RTOL against itself re-chunked
# (`test_xlstm_gradients_within_their_conditioning`); the models below
# are held to GRAD_RTOL.
XLSTM_GRAD_RTOL = 2e-3
WELL_CONDITIONED = [n for n in ARCH_NAMES if n != "xlstm-125m"]
WINDOW = 8   # Gemma-2's local window, cut so that it bites at S = 16
S, B = 16, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name):
    jcfg = jax_get_config(name, reduced=True)
    tcfg = get_config(name, reduced=True)
    if name == "gemma2-9b":
        jcfg = jcfg.replace(pattern=(JaxLayerSpec("attn", WINDOW, "dense"),
                                     JaxLayerSpec("attn", 0, "dense")))
        tcfg = tcfg.replace(pattern=(LayerSpec("attn", WINDOW, "dense"),
                                     LayerSpec("attn", 0, "dense")))
    return jcfg, tcfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed, vocab, lead=(B,)):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, vocab, lead + (S + 1,)).astype(np.int32)
    jb = {"tokens": jnp.asarray(seqs[..., :-1]),
          "labels": jnp.asarray(seqs[..., 1:])}
    return jb, {k: _t(v) for k, v in jb.items()}


def _model_batch(seed, jcfg):
    """``_batch``, and the front end's stub inputs (JAX's shapes, numpy
    unit normals): the VLM's patch embeddings in front of the S text
    tokens, whisper's encoder frames."""
    jb, tb = _batch(seed, jcfg.vocab_size)
    stub = {"vision_stub": ("patch_embeds", jcfg.prefix_tokens),
            "audio_stub": ("frames", jcfg.encoder_seq)}.get(jcfg.frontend)
    if stub is not None:
        name, length = stub
        x = np.random.default_rng(seed + 100).standard_normal(
            (B, length, jcfg.frontend_dim)).astype(np.float32)
        jb[name], tb[name] = jnp.asarray(x), _t(x)
    return jb, tb


def _carry_plan(jplan):
    p = jplan.plan if hasattr(jplan, "plan") else jplan.state.plan
    state = jplan.state
    tstate = cwfl_state_from_arrays(
        [np.asarray(x) for x in (p.assignment, p.heads, p.membership,
                                 p.cluster_snr, p.head_mask)],
        *(np.asarray(getattr(state, n)) for n in (
            "client_power", "total_power", "head_noise_std",
            "consensus_noise_std", "mix")), device="cpu")
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan) if f.name != "state"}
    return fl_plan_from_arrays(fields, tstate)


def _assert_leaves_close(got, want, atol=None, rtol=None):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b.astype(jnp.float32))
        a = a.detach().to(torch.float32).numpy()
        assert a.shape == b.shape
        err = float(np.abs(a - b).max())
        if rtol is not None:
            assert err <= rtol * max(float(np.abs(b).max()), 1e-30)
        else:
            assert err <= atol


@pytest.fixture(scope="module", params=WELL_CONDITIONED)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = _configs("gemma2-9b")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jplan = jax_make_fl_plan(4, 2, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tparams, jplan, _carry_plan(jplan)


# ---------------------------------------------------------------------------
# The model's gradient and the single-model step.
# ---------------------------------------------------------------------------

def test_forward_gradients_match_jax(model):
    """``forward``'s CE and its gradient, leaf by leaf, against
    ``jax.value_and_grad`` of the JAX package's loss."""
    jcfg, tcfg, jparams, tparams = model
    jb, tb = _model_batch(1, jcfg)
    (jloss, jce), jgrads = jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    (tloss, tce), tgrads = tsteps.value_and_grad(
        tsteps.make_loss_fn(tcfg), tparams, tb)
    np.testing.assert_allclose(float(tce), float(jce), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    treedef = jax.tree.structure(jgrads)
    _assert_leaves_close(
        params_from_jax(jax.tree.unflatten(treedef, [
            x.numpy() for x in tgrads]), device="cpu"), jgrads,
        rtol=GRAD_RTOL)
    assert all(not p.requires_grad for p in tree_leaves(tparams))


def test_xlstm_gradients_within_their_conditioning():
    """xlstm-125m (see XLSTM_GRAD_RTOL): the gradient against JAX's within
    its conditioning, and against the port's own with the mLSTM chunked
    by 8 instead of 32 within GRAD_RTOL."""
    jcfg, tcfg = _configs("xlstm-125m")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jb, tb = _model_batch(1, jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    grads = {}
    for chunk in (tcfg.mlstm_chunk, 8):
        cfg = tcfg.replace(mlstm_chunk=chunk)
        (loss, _), grads[chunk] = tsteps.value_and_grad(
            tsteps.make_loss_fn(cfg), tparams, tb)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    treedef = jax.tree.structure(jgrads)

    def tree(g):
        return params_from_jax(jax.tree.unflatten(
            treedef, [x.numpy() for x in g]), device="cpu")

    _assert_leaves_close(tree(grads[tcfg.mlstm_chunk]), jgrads,
                         rtol=XLSTM_GRAD_RTOL)
    _assert_leaves_close(tree(grads[8]), jax.tree.unflatten(
        treedef, [jnp.asarray(x.numpy())
                  for x in grads[tcfg.mlstm_chunk]]), rtol=GRAD_RTOL)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(tsteps.cross_entropy(_t(logits), _t(labels))),
        float(jsteps.cross_entropy(jnp.asarray(logits),
                                   jnp.asarray(labels))), rtol=1e-6)


def test_single_model_train_step_two_steps(model):
    """``steps.make_train_step`` with SGD, two steps on two batches."""
    jcfg, tcfg, jparams, tparams = model
    jstep = jax.jit(jsteps.make_train_step(jcfg, jax_sgd(0.1)))
    tstep = tsteps.make_train_step(tcfg, sgd(0.1))
    jstate, tstate = jax_sgd(0.1).init(jparams), sgd(0.1).init(tparams)
    jp, tp = jparams, tparams
    for seed in (3, 4):
        jb, tb = _model_batch(seed, jcfg)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL)
    _assert_leaves_close(tp, jp, atol=PARAM_ATOL)
    # The step leaves the params it was given as they were.
    _assert_leaves_close(tparams, jparams, atol=0.0)


# ---------------------------------------------------------------------------
# Shard mode and replica mode.
# ---------------------------------------------------------------------------

def _jax_leaf_noise(key, leaves, dtype):
    """`repro.utils.tree_add_noise`'s unit normals: one split key a leaf,
    drawn in the gradient's dtype."""
    keys = jax.random.split(key, len(leaves))
    return [jax.random.normal(k, x.shape, dtype) for x, k in
            zip(leaves, keys)]


@pytest.mark.parametrize("M,accum", [(1, "float32"), (2, "float32"),
                                     (2, "bfloat16")])
def test_shard_step_matches_jax(gemma, M, accum):
    """``dist_steps.make_train_step``: the plan's example weights, M
    microbatches summed in ``accum`` (one microbatch sums nothing, in
    either package, whatever ``accum``), JAX's per-leaf channel noise
    passed across, SGD; two steps."""
    jcfg, tcfg, jparams, tparams, jplan, tplan = gemma
    shape = JaxInputShape("t", S, B, "train")
    jfn, _, _ = jds.make_train_step(
        jcfg, shape, make_local_mesh(1, 1), plan=jplan, lr=0.05,
        microbatches=M, accum_dtype=getattr(jnp, accum))
    jfn = jax.jit(jfn)
    tfn = tds.make_train_step(tcfg, InputShape("t", S, B, "train"),
                              plan=tplan, lr=0.05, microbatches=M,
                              accum_dtype=getattr(torch, accum))
    grad_dtype = jnp.float32 if M == 1 else getattr(jnp, accum)
    jp, tp = jparams, tparams
    jst, tst = jax_sgd(0.05).init(jparams), sgd(0.05).init(tparams)
    for step in range(2):
        jb, tb = _batch(10 + step, tcfg.vocab_size)
        key = jax.random.PRNGKey(20 + step)
        noise = [params_from_jax(np.asarray(n), device="cpu") for n in
                 _jax_leaf_noise(key, jax.tree.leaves(jp), grad_dtype)]
        jp, jst, jm = jfn(jp, jst, jb, key)
        tp, tst, tm = tfn(tp, tst, tb, noise)
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL)
    _assert_leaves_close(tp, jp, atol=PARAM_ATOL if accum == "float32"
                         else BF16_PARAM_ATOL)
    assert jplan.noise_std > 0.0


def test_shard_step_resharded_ce_is_gather_on_one_card(gemma):
    """``ce_mode="resharded"`` (a mesh hint) computes what "gather"
    computes on one card; an unknown mode is refused."""
    _, tcfg, _, tparams, _, tplan = gemma
    _, tb = _batch(5, tcfg.vocab_size)
    shape = InputShape("t", S, B, "train")
    outs = []
    for mode in ("gather", "resharded"):
        fn = tds.make_train_step(tcfg, shape, plan=tplan, microbatches=1,
                                 ce_mode=mode)
        outs.append(fn(tparams, sgd(1e-3).init(tparams), tb,
                       torch.Generator().manual_seed(0)))
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ce_mode"):
        tds.make_train_step(tcfg, shape, ce_mode="scatter")


def test_replica_step_matches_jax_through_one_fused_round(gemma,
                                                          monkeypatch):
    """``make_replica_train_step`` at JAX's setting
    (tests/test_ota_collectives.py: the reduced Gemma-2, shape (16, 4),
    plan (4, 2)), two local steps a client on divergent client params,
    JAX's sync noise passed through the port's (unit1, unit2) seam; the
    sync flattens once into the round at (K, d > 512)."""
    jcfg, tcfg, _, _, jplan, tplan = gemma
    K = jplan.num_clients
    shape = JaxInputShape("t", S, B, "train")
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jtfm.init_params(jax.random.PRNGKey(30 + k), jcfg)
        for k in range(K)])
    tstacked = params_from_jax(jax.tree.map(np.asarray, jstacked),
                               device="cpu")
    jb, tb = _batch(6, tcfg.vocab_size, lead=(K, B // K))
    key = jax.random.PRNGKey(7)
    jfn, _, _ = jds.make_replica_train_step(jcfg, shape,
                                            make_local_mesh(1, 1), jplan,
                                            lr=0.05, local_steps=2)
    jout, jloss = jax.jit(jfn)(jstacked, jb, key)

    leaves = jax.tree.leaves(jstacked)
    ones = jnp.ones((jplan.num_clusters,), jnp.float32)
    noise = tuple(_t(jcwfl._flat_leaf_noise(k, leaves, jplan.num_clusters,
                                            ones))
                  for k in jax.random.split(key))
    calls = []
    real = tcwfl.cwfl_round
    monkeypatch.setattr(tcwfl, "cwfl_round", lambda *a, **kw: calls.append(
        tuple(a[0].shape)) or real(*a, **kw))
    tfn = tds.make_replica_train_step(tcfg, InputShape("t", S, B, "train"),
                                      tplan, lr=0.05, local_steps=2)
    tout, tloss = tfn(tstacked, tb, noise)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_leaves_close(tout, jout, atol=PARAM_ATOL)
    assert len(calls) == 1
    assert calls[0][0] == K and calls[0][1] > 512


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES) + ["cut"])
def test_auto_microbatches_matches_jax(name, shape_name):
    """Every dense configuration the port registers, at every input shape
    of the JAX package (and ``train_4k`` cut to 4 sequences, the chip
    run's), on one device; and the MoE branch on a configuration with
    experts."""
    jmesh = make_local_mesh(1, 1)
    for jcfg, tcfg in ((jax_get_config(name), get_config(name)),
                       (jax_get_config(name).replace(num_experts=8, top_k=2),
                        get_config(name).replace(num_experts=8, top_k=2))):
        if shape_name == "cut":
            jshape = JaxInputShape("train_4k", 4096, 4, "train")
            tshape = InputShape("train_4k", 4096, 4, "train")
        else:
            jshape, tshape = JAX_SHAPES[shape_name], INPUT_SHAPES[shape_name]
        want = jds.auto_microbatches(jcfg, jshape, jmesh)
        assert tds.auto_microbatches(tcfg, tshape) == want
    if name == "qwen2.5-3b" and shape_name == "cut":
        assert want == 4   # one sequence a microbatch on the card


def test_param_shapes_are_meta():
    cfg = get_config("qwen2.5-3b")
    shapes = tds.param_shapes(cfg)
    assert all(x.device.type == "meta" for x in tree_leaves(shapes))
    jshapes = jds.param_shapes(jax_get_config("qwen2.5-3b"))
    assert [tuple(x.shape) for x in tree_leaves(shapes)] == [
        tuple(x.shape) for x in jax.tree.leaves(jshapes)]


# ---------------------------------------------------------------------------
# The example twin.
# ---------------------------------------------------------------------------

def _twin():
    spec = importlib.util.spec_from_file_location(
        "train_lm_cwfl_torch", ROOT / "examples" / "train_lm_cwfl_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_twin_matches_the_jax_example_loop(capsys):
    """``run`` on the JAX example's lm-6m, plan (K = 4, C = 3, 40 dB),
    initial params and tokens (keys 0, 2 and 1; 64 sequences of 32
    tokens here), and its loop's draws (key 3: batch indices and the
    per-leaf channel noise), for three steps of batch 8, against the JAX
    example's loop; the twin prints the JAX example's lines."""
    from repro.data import make_token_dataset as jax_tokens
    from repro.models.config import ArchConfig as JaxArchConfig

    twin = _twin()
    tcfg = twin.lm_config(False)
    jcfg = JaxArchConfig(**{f.name: getattr(tcfg, f.name) for f in
                            dataclasses.fields(tcfg) if f.name != "pattern"},
                         pattern=(JaxLayerSpec(),))
    steps, batch, seq, lr = 3, 8, 32, 0.3
    jplan = jax_make_fl_plan(4, 3, jax.random.PRNGKey(0), snr_db=40.0)
    data = jax_tokens(jax.random.PRNGKey(1), jcfg.vocab_size,
                      num_sequences=64, seq_len=seq)
    jparams = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    jfn, _, _ = jds.make_train_step(
        jcfg, JaxInputShape("train", seq, batch, "train"),
        make_local_mesh(1, 1), plan=jplan, lr=lr, microbatches=1)
    jfn = jax.jit(jfn)
    jp, jst = jparams, jax_sgd(lr).init(jparams)
    key = jax.random.PRNGKey(3)
    draws, jce = [], []
    for _ in range(steps):
        k_it, k_noise, key = jax.random.split(key, 3)
        idx = jax.random.randint(k_it, (batch,), 0, data.shape[0])
        seqs = data[idx]
        noise = _jax_leaf_noise(k_noise, jax.tree.leaves(jp), jnp.float32)
        draws.append((_t(idx).long(), [_t(n) for n in noise]))
        jp, jst, jm = jfn(jp, jst, {"tokens": seqs[:, :-1],
                                    "labels": seqs[:, 1:]}, k_noise)
        jce.append(float(jm["ce"]))

    out = twin.run(tcfg, _carry_plan(jplan),
                   params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
                   _t(data), steps=steps, batch=batch, lr=lr,
                   draws=lambda s: draws[s], log_every=1)
    np.testing.assert_allclose(out["ce"], jce, rtol=LOSS_RTOL)
    _assert_leaves_close(out["params"], jp, atol=PARAM_ATOL)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("step    0  ce=") and len(printed) == steps
