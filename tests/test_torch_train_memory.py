"""The memory mechanisms of JAX's training on the port, each computing the
same numbers: ``cfg.remat`` (a period checkpointed, as JAX's
``jax.checkpoint`` of ``one_period``), the donated train step (JAX's
``donate_argnums=(0, 1)``: the step works in place), and the selective
scan's chunks recomputed in the backward; then one shard step of each
reduced configuration with both on, against JAX's step with ``remat=True``.

On the CPU the embedding table's gradient is summed by ``index_put_`` with
accumulate over threads, in another order run to run; the bitwise checks
run with ``torch.use_deterministic_algorithms(True)``, which serialises
it (the other leaves are bitwise either way)."""
import jax
import numpy as np
import pytest
import torch

from repro.dist.fl_integration import make_fl_plan as jax_make_fl_plan
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jtfm
from repro.models.config import InputShape as JaxInputShape
from repro.optim import sgd as jax_sgd
from repro.training import dist_steps as jds
from repro_torch.configs import ARCH_NAMES
from repro_torch.convert import params_from_jax
from repro_torch.dist.fl_integration import make_fl_plan
from repro_torch.models import ssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import InputShape
from repro_torch.models.inputs import make_batch
from repro_torch.optim import sgd
from repro_torch.training import dist_steps as tds
from repro_torch.training import steps as tsteps
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_lm_train import (B, GRAD_RTOL, LOSS_RTOL, S, XLSTM_GRAD_RTOL,
                                 WELL_CONDITIONED, _assert_leaves_close,
                                 _carry_plan, _configs, _jax_leaf_noise,
                                 _model_batch)


@pytest.fixture(autouse=True)
def _deterministic_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


def _grads(cfg, params, batch):
    return tsteps.value_and_grad(tsteps.make_loss_fn(cfg), params, batch)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_is_bitwise_the_step_without_it(name):
    """Loss, CE and every gradient with each period checkpointed are the
    bits of the forward without (the recomputation runs the same ops on
    the same inputs); the router losses summed a period at a time in
    both, as JAX sums them."""
    _, cfg = _configs(name)
    params = ttfm.init_params(0, cfg, device="cpu")
    batch = make_batch(3, cfg, S, B, kind="train", device="cpu")
    (l0, c0), g0 = _grads(cfg, params, batch)
    (l1, c1), g1 = _grads(cfg.replace(remat=True), params, batch)
    assert torch.equal(l0, l1) and torch.equal(c0, c1)
    assert _bitwise(g0, g1)


@pytest.mark.parametrize("name,M,noise_kind", [
    ("gemma2-9b", 1, "leaves"), ("gemma2-9b", 2, "generator"),
    ("jamba-v0.1-52b", 2, "leaves"), ("qwen3-moe-235b-a22b", 1,
                                      "generator")])
def test_donated_step_is_bitwise_the_functional_step(name, M, noise_kind):
    """Two steps with a plan (example weights, channel noise): the donated
    step's loss, params and optimizer state are the functional step's
    bits; it hands back the caller's tensors, updated in place, and the
    functional step leaves its input as it was."""
    _, cfg = _configs(name)
    plan = make_fl_plan(4, 2, 0, device="cpu")
    shape = InputShape("t", S, B, "train")
    start = ttfm.init_params(0, cfg, device="cpu")
    batches = [make_batch(seed, cfg, S, B, kind="train", device="cpu")
               for seed in (4, 5)]
    runs = {}
    for donate in (False, True):
        fn = tds.make_train_step(cfg, shape, plan=plan, lr=0.05,
                                 microbatches=M, donate=donate)
        params = tree_map(lambda a: a.clone(), start)
        state = sgd(0.05).init(params)
        gen = torch.Generator().manual_seed(9)
        losses = []
        for batch in batches:
            noise = (gen if noise_kind == "generator" else
                     [torch.randn(x.shape, generator=gen)
                      for x in tree_leaves(params)])
            given = tree_leaves(params)
            out, state, m = fn(params, state, batch, noise)
            same = all(a is b for a, b in zip(tree_leaves(out), given))
            assert same == donate
            params = out
            losses.append(m["loss"])
        runs[donate] = (tree_leaves(params), state, losses)
    assert _bitwise(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert _bitwise(runs[True][2], runs[False][2])
    assert plan.noise_std > 0.0
    fn = tds.make_train_step(cfg, shape, plan=plan, microbatches=M)
    kept = tree_map(lambda a: a.clone(), start)
    fn(kept, sgd(1e-3).init(kept), batches[0],
       torch.Generator().manual_seed(0))
    assert _bitwise(tree_leaves(kept), tree_leaves(start))


def _mamba_inputs(d_inner=24, L=70, chunk=16, d_state=4, dt_rank=3):
    g = torch.Generator().manual_seed(0)
    params = ssm.mamba_init(g, 16, d_inner, d_state, 4, dt_rank,
                            torch.float32, "cpu")
    params = {k: v.requires_grad_() for k, v in params.items()}
    xz = torch.randn(2, L, d_inner, generator=g).requires_grad_()
    h0 = torch.randn(2, d_inner, d_state, generator=g).requires_grad_()
    return params, xz, h0, (d_state, dt_rank, chunk)


def test_chunk_recomputed_scan_gradients_are_plain_autograd_bitwise(
        monkeypatch):
    """The selective scan with every chunk recomputed in the backward
    against the same scan with autograd keeping every doubling step
    (``checkpoint`` replaced by a plain call): outputs, final state and
    the gradients of the input, the carried state and every parameter,
    bitwise, over a ragged last chunk."""
    params, xz, h0, (d_state, dt_rank, chunk) = _mamba_inputs()
    inputs = [xz, h0] + [params[k] for k in ("x_proj", "dt_proj", "dt_bias",
                                             "A_log", "D")]

    def grads():
        y, h = ssm.selective_scan(params, xz, d_state, dt_rank, chunk,
                                  h0=h0)
        loss = (y * torch.linspace(-1, 1, y.shape[-1])).sum() + (h * h).sum()
        return [y, h] + list(torch.autograd.grad(loss, inputs))

    recomputed = grads()
    monkeypatch.setattr(ssm, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    plain = grads()
    assert _bitwise(recomputed, plain)


def test_chunk_recomputed_scan_keeps_two_small_tensors_a_chunk(monkeypatch):
    """What autograd saves for the backward: with the chunks recomputed,
    about a chunk's input and carried state (plus the parameters, saved
    once a chunk); with every doubling step kept, more than 20× that at
    this width (log2(16) = 4 steps, each saving (B, chunk, d_inner, N)
    products).  The saving grows with d_state and the chunk: at Jamba's
    width (PERF.md) from ≈ 34 GB to ≈ 0.14 GB a mamba layer at 4,096
    positions."""
    params, xz, h0, (d_state, dt_rank, chunk) = _mamba_inputs(
        d_inner=32, L=128, d_state=16)

    def saved_bytes():
        seen = {}

        def pack(t):
            seen[(t.data_ptr(), t.shape, t.stride())] = (
                t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, h = ssm.selective_scan(params, xz, d_state, dt_rank, chunk,
                                      h0=h0)
        del y, h
        return sum(seen.values())

    recomputed = saved_bytes()
    monkeypatch.setattr(ssm, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    plain = saved_bytes()
    assert plain > 20 * recomputed, (plain, recomputed)


def test_serving_scan_runs_no_checkpoint(monkeypatch):
    """Without autograd the chunks run as they did: no checkpoint, the same
    bits."""
    params, xz, h0, (d_state, dt_rank, chunk) = _mamba_inputs()
    with torch.no_grad():
        want = ssm.selective_scan(params, xz, d_state, dt_rank, chunk,
                                  h0=h0)
        monkeypatch.setattr(ssm, "checkpoint", None)
        got = ssm.selective_scan(params, xz, d_state, dt_rank, chunk, h0=h0)
    assert _bitwise(got, want)


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if n not in ("gemma2-9b", "qwen2.5-3b")])
def test_shard_step_with_remat_and_donation_matches_jax(name):
    """One shard-mode step of each reduced configuration of the other
    mixers and front ends, and of phi4-mini and llama3-405b, with remat
    and donation on, against JAX's step (``remat=True``, jitted) on JAX's
    weights, plan, tokens and per-leaf channel noise: the loss within
    LOSS_RTOL, each leaf's update (new − old) within GRAD_RTOL of JAX's
    relative to its largest magnitude (xlstm-125m: XLSTM_GRAD_RTOL, its
    gradient's conditioning), plus the two params' roundings (an f32 ulp
    of the leaf's largest param each)."""
    jcfg, tcfg = _configs(name)
    _assert_shard_step_matches_jax(name, jcfg.replace(remat=True),
                                   tcfg.replace(remat=True))


def test_kimi_k2_step_at_head_dim_112_matches_jax():
    """The reduced Kimi K2 with its published head dim, 112: the port's
    attention pads it to 128 (`repro_torch.kernels.ops.pad_head_dim`) and
    slices the gradient back; one shard step with remat and donation
    against JAX's, as above."""
    name = "kimi-k2-1t-a32b"
    jcfg, tcfg = _configs(name)
    _assert_shard_step_matches_jax(
        name, jcfg.replace(remat=True, head_dim=112),
        tcfg.replace(remat=True, head_dim=112))


def _assert_shard_step_matches_jax(name, jcfg, tcfg):
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jplan = jax_make_fl_plan(4, 2, jax.random.PRNGKey(0))
    jfn, _, _ = jds.make_train_step(jcfg, JaxInputShape("t", S, B, "train"),
                                    make_local_mesh(1, 1), plan=jplan,
                                    lr=0.05, microbatches=1)
    tfn = tds.make_train_step(tcfg, InputShape("t", S, B, "train"),
                              plan=_carry_plan(jplan), lr=0.05,
                              microbatches=1, donate=True)
    jb, tb = _model_batch(6, jcfg)
    key = jax.random.PRNGKey(21)
    noise = [params_from_jax(np.asarray(n), device="cpu") for n in
             _jax_leaf_noise(key, jax.tree.leaves(jparams), np.float32)]
    jnew, _, jm = jax.jit(jfn)(jparams, jax_sgd(0.05).init(jparams), jb,
                               key)
    start = [x.clone() for x in tree_leaves(tparams)]
    tnew, _, tm = tfn(tparams, sgd(0.05).init(tparams), tb, noise)
    assert tree_leaves(tnew)[0] is tree_leaves(tparams)[0]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    rtol = XLSTM_GRAD_RTOL if name not in WELL_CONDITIONED else GRAD_RTOL
    for got, s, want, w0 in zip(tree_leaves(tnew), start,
                                jax.tree.leaves(jnew),
                                jax.tree.leaves(jparams)):
        w0 = np.asarray(w0, np.float32)
        upd = np.asarray(want, np.float32) - w0
        err = float(np.abs((got - s).numpy() - upd).max())
        # The update read back from the stored params carries their
        # rounding: one f32 ulp of the largest param a side.
        ulp = float(np.spacing(np.abs(w0).max()))
        assert err <= rtol * float(np.abs(upd).max()) + 2 * ulp
