"""The port's channel process against JAX's engine in each context it runs
the process in, bit for bit: the scanned trajectory (``lax.scan``, the
round unrolled twice), the loop's jitted round and the vmapped sweep's
round, ten cluster-churn rounds each.

JAX's `step_channel` and `channel_view` are wrapped, for the run, with a
``jax.debug.callback`` that hands the host each round's state before and
after the step, its key, and the view; the taps add outputs to the
round, not arithmetic (the tapped run's losses are the untapped run's).
The port steps each tapped state with the draws of the tapped key and
views each tapped state; its first state is `init_channel`'s in the
context JAX's setup computes it (eagerly in a run, under ``jit`` in a
sweep; at each topology here the two part in the last bit, so a sweep's
first state is not its lone run's, in JAX as in the port).  A sweep's
callbacks are unordered: each record stands alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.data import synthetic as jdata
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS
from repro.training import FLConfig as JaxFLConfig
from repro_torch.convert import topology_from_arrays
from repro_torch.core import topology as ttopo
from repro_torch.sim import processes as tproc
from repro_torch.sim.scenarios import get_scenario

torch.set_num_threads(1)

ROUNDS = 10
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_erf_inv_draw = jax.jit(
    lambda key, shape: jax.lax.erf_inv(jax.random.uniform(
        key, shape, jnp.float32, _LO, 1.0)), static_argnums=1)


def _draws(key, K):
    """`step_channel`'s draws from its key: erf_inv(u), JAX's normal
    before its √2, and the waypoint uniforms."""
    k_fade, k_shadow, k_way = jax.random.split(key, 3)
    k_re, k_im = jax.random.split(k_fade)
    return tproc.ChannelDraws(
        *(torch.from_numpy(np.array(_erf_inv_draw(k, (K, K))))
          for k in (k_re, k_im, k_shadow)),
        waypoints=torch.from_numpy(np.array(
            jax.random.uniform(k_way, (K, 2)))))


def _tapped_run(monkeypatch, context, K, seed):
    """JAX's cluster-churn run in ``context``, every round's channel step
    and view tapped."""
    records = []
    step0, view0 = jengine.step_channel, jengine.channel_view

    def tap(kind, *arrays):
        jax.debug.callback(lambda *a: records.append(
            (kind, [np.array(x) for x in a])), *arrays,
            ordered=context != "sweep")

    def step(state, cfg, tcfg, key):
        new = step0(state, cfg, tcfg, key)
        tap("step", jax.random.key_data(key)
            if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key,
            *state, *new)
        return new

    def view(state, tcfg):
        v = view0(state, tcfg)
        tap("view", *state, *v)
        return v

    monkeypatch.setattr(jengine, "step_channel", step)
    monkeypatch.setattr(jengine, "channel_view", view)
    dcfg = jdata.SyntheticImageConfig.mnist_like(num_train=24 * K,
                                                 num_test=64)
    (xtr, ytr), (xte, yte) = jdata.make_synthetic_images(
        jax.random.PRNGKey(0), dcfg)
    xs, ys = jdata.partition_iid(jax.random.PRNGKey(1), xtr, ytr, K)
    tcfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.make_topology(jax.random.PRNGKey(seed), tcfg)
    init, apply = jsmall.make_mnist_mlp(hidden=(8,))
    loss = lambda p, x, y: jsmall.nll_loss(apply(p, x), y)   # noqa: E731
    cfg = JaxFLConfig(strategy="cwfl", rounds=ROUNDS, snr_db=40.0,
                      eval_samples=64, seed=0, batch_size=8)
    args = (init, apply, loss, topo, xs, ys, xte, yte, cfg)
    kw = dict(scenario=JAX_SCENARIOS["cluster-churn"], topo_cfg=tcfg)
    if context == "sweep":
        jengine.run_monte_carlo(*args, seeds=2, **kw)
    else:
        jengine.run_rounds(*args, mode=context, **kw)
    jax.effects_barrier()
    return topo, records


def _same(got: torch.Tensor, ref: np.ndarray) -> bool:
    got = got.numpy()
    return got.dtype == ref.dtype and np.array_equal(got.view(np.uint8),
                                                     ref.view(np.uint8))


@pytest.mark.parametrize("context,K,seed", [
    ("scan", 8, 19), ("loop", 8, 19), ("sweep", 8, 19), ("scan", 50, 3)])
def test_channel_round_is_jax_in_the_engine(monkeypatch, context, K, seed):
    topo, records = _tapped_run(monkeypatch, context, K, seed)
    n = 2 if context == "sweep" else 1
    assert [kind for kind, _ in records].count("step") == n * ROUNDS
    tcfg = ttopo.TopologyConfig(num_clients=K)
    pcfg = get_scenario("cluster-churn").channel
    top = topology_from_arrays(np.asarray(topo.positions),
                               np.asarray(topo.link_gain), tcfg,
                               device="cpu")
    mode = "jit" if context == "sweep" else "eager"
    init = tproc.init_channel(top, tcfg, torch.zeros(K, 2), mode=mode)
    # At these topologies the eager and the jitted pathloss part in the
    # last bit at some links, so JAX's sweep starts its trajectories from
    # another first state than its lone runs do; the port follows each.
    other = tproc.init_channel(top, tcfg, torch.zeros(K, 2),
                               mode="eager" if mode == "jit" else "jit")
    t = firsts = 0
    for kind, a in records:
        if kind == "step":
            key, old, new = a[0], a[1:5], a[5:]
            if not old[3].any():     # a first round: no shadowing yet
                firsts += 1
                assert _same(init.positions, old[0])
                assert _same(init.h_tilde, old[2])
                assert not _same(other.h_tilde, old[2])
            t += 1
            state = tproc.ChannelState(*(torch.from_numpy(x) for x in old))
            got, _ = tproc.step_and_view(state, pcfg, tcfg,
                                         _draws(jnp.asarray(key), K))
            for name, g, r in zip(got._fields, got, new):
                assert _same(g, r), (context, t, name)
        else:
            state = tproc.ChannelState(*(torch.from_numpy(x)
                                         for x in a[:4]))
            view = tproc.channel_round(*state, None,
                                       tproc._constants(pcfg, tcfg, K))[4:]
            view = tproc.ChannelView(*view)
            for name, g, r in zip(view._fields, view, a[4:]):
                assert _same(g, r), (context, t, name)
    assert firsts == n
