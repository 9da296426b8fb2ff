"""The port's optimizer substrate (`repro_torch.optim`) against the JAX
package's `repro.optim`: the schedules step by step, SGD with momentum
and AdamW update by update on the same gradients, and the quadratic
minimisations of ``tests/test_substrate.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.convert import params_from_jax
from repro_torch.utils.pytree import tree_leaves

STEPS = np.arange(0, 201)


@pytest.mark.parametrize("make", [
    lambda m: m.inverse_time_schedule(mu=1.0, gamma=12.0),
    lambda m: m.inverse_time_schedule(mu=2.0, gamma=10.0),
    lambda m: m.cosine_schedule(1.0, 100, warmup=10),
    lambda m: m.cosine_schedule(3e-3, 200),
    lambda m: m.cosine_schedule(0.1, 150, warmup=20),
    lambda m: m.cosine_schedule(1e-3, 57, warmup=7),
], ids=["inverse_time_12", "inverse_time_10", "cosine_warm10",
        "cosine_nowarm", "cosine_warm20", "cosine_ragged"])
def test_schedule_matches_jax(make):
    """Steps 0-200 (past the cosine's end, where it stays 0): f32
    arithmetic in both, the cosine correctly rounded on both sides (XLA's
    is within an ulp of it), so rel 1e-6."""
    jsched, tsched = make(jopt), make(topt)
    ref = np.array([float(jsched(jnp.asarray(s, jnp.float32)))
                    for s in STEPS])
    got = np.array([tsched(int(s)) for s in STEPS])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_schedule_takes_the_optimizer_step_as_jax():
    """JAX's optimizers hand the schedule their int32 step; the port's its
    int step: the same values."""
    for make in (lambda m: m.inverse_time_schedule(1.0, 12.0),
                 lambda m: m.cosine_schedule(0.5, 40, warmup=5)):
        jsched, tsched = make(jopt), make(topt)
        np.testing.assert_allclose(
            [tsched(s) for s in range(50)],
            [float(jsched(jnp.asarray(s, jnp.int32))) for s in range(50)],
            rtol=1e-6)


def _tree(seed):
    """A two-layer param tree and 20 gradients of it, numpy f32."""
    rng = np.random.default_rng(seed)
    params = {"fc0": {"w": rng.standard_normal((6, 5)),
                      "b": rng.standard_normal(5)},
              "fc1": {"w": rng.standard_normal((5, 3)),
                      "b": rng.standard_normal(3)}}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32), params) for _ in range(20)]
    return params, grads


@pytest.mark.parametrize("make", [
    lambda m: m.sgd(0.05),
    lambda m: m.sgd_momentum(0.05, 0.9),
    lambda m: m.sgd_momentum(m.inverse_time_schedule(1.0, 12.0), 0.5),
    lambda m: m.adamw(1e-2),
    lambda m: m.adamw(3e-3, weight_decay=0.1),
    lambda m: m.adamw(m.cosine_schedule(1e-2, 20, warmup=3), b1=0.8,
                      b2=0.99, weight_decay=0.05),
], ids=["sgd", "momentum", "momentum_inverse_time", "adamw",
        "adamw_decay", "adamw_cosine_decay"])
def test_optimizer_steps_match_jax(make):
    """20 updates on the same gradients, each applied as ``p + u``: the
    updates and the params after every step, within rel 1e-5 (f32 in
    another order)."""
    params, grads = _tree(0)
    jo, to = make(jopt), make(topt)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = tree_leaves(params_from_jax(params, device="cpu"))
    ts = to.init(params_from_jax(params, device="cpu"))
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(jnp.add, jp, ju)
        tu, ts = to.update(tree_leaves(params_from_jax(g, device="cpu")),
                           ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tu, jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)
        for a, b in zip(tp, jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_adamw_moments_stay_f32_for_bf16_params():
    """JAX keeps AdamW's state in f32 whatever the params' dtype; the
    updates come out in the params' dtype."""
    params = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    opt = topt.adamw(1e-2, weight_decay=0.1)
    state = opt.init(params)
    assert all(m.dtype == torch.float32 for m in state.mu + state.nu)
    grads = [torch.full((4, 3), 0.5, dtype=torch.bfloat16)]
    updates, state = opt.update(grads, state, tree_leaves(params))
    assert updates[0].dtype == torch.bfloat16
    assert state.mu[0].dtype == torch.float32 and state.step == 1
    with pytest.raises(ValueError, match="params"):
        opt.update(grads, state)


def _quad_min(opt, steps=200):
    """``tests/test_substrate.py``'s f = ‖x‖² from (5, −3)."""
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    leaves = tree_leaves(params)
    for _ in range(steps):
        grads = [2 * p for p in leaves]
        updates, state = opt.update(grads, state, leaves)
        leaves = [p + u for p, u in zip(leaves, updates)]
    return float(torch.sum(leaves[0] ** 2))


@pytest.mark.parametrize("make,limit", [
    (lambda: topt.sgd(0.1), 1e-6),
    (lambda: topt.sgd_momentum(0.05, 0.9), 1e-6),
    (lambda: topt.adamw(0.1), 1e-3),
], ids=["sgd", "momentum", "adamw"])
def test_minimizes_quadratic(make, limit):
    assert _quad_min(make()) < limit


def test_local_runner_hands_the_params_to_the_optimizer():
    """`make_local_runner` passes the leaves to ``update`` as JAX's runner
    passes the params: AdamW's weight decay pulls a zero-gradient client
    toward 0."""
    from repro_torch.training.local import make_local_runner

    opt = topt.adamw(0.1, weight_decay=1.0)
    run = make_local_runner(lambda p, x, y: 0.0 * p["w"].sum(dim=(1, 2)),
                            opt, batch_size=2, local_steps=3)
    params = {"w": torch.ones(2, 3, 4)}
    x, y = torch.zeros(2, 5, 1), torch.zeros(2, 5, dtype=torch.long)
    idx = torch.zeros(2, 3, 2, dtype=torch.long)
    out, state, _ = run(params, opt.init(params), x, y, idx)
    assert state.step == 3
    # three steps of p ← p − 0.1·p: 0.9³
    np.testing.assert_allclose(out["w"].numpy(), 0.9 ** 3, rtol=1e-6)
