"""Write `scripts/churn_tie_k8_seed19.json`: the cluster-head tie that
``chip_smoke.py``'s tie phase holds the card to, from the JAX package on
the CPU.

The topology is JAX's ``make_topology(PRNGKey(19))`` at K = 8, whose
round-0 re-clustering in a cluster-churn run (``cfg.seed`` = 0) is a tie:
JAX's eager election picks another head than its jitted one.  The file
holds the topology's positions and gains, the run's channel draws for
rounds 0..5 as the port's seam takes them (erf_inv(u), the normal before
its √2, and the waypoint uniforms), the first waypoints, each round's
K-means first centre, and the heads JAX elects at rounds 0 and 5, eagerly
and under ``jit``, on the round's view (JAX's jitted step and view, the
bits of its engine's round: `tests/test_torch_channel_xla.py`).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/jax_tie_reference.py
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import clustering as jcl
from repro.core import topology as jtopo
from repro.sim import engine as jengine
from repro.sim import processes as jproc
from repro.sim.scenarios import SCENARIOS

K, C, SEED, ROUNDS = 8, 3, 19, 6
OUT = Path(__file__).with_name("churn_tie_k8_seed19.json")
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def erf_inv_draw(key, shape):
    return jax.lax.erf_inv(jax.random.uniform(key, shape, jnp.float32, _LO,
                                              1.0))


def main() -> None:
    tcfg = jtopo.TopologyConfig(num_clients=K)
    topo = jtopo.make_topology(jax.random.PRNGKey(SEED), tcfg)
    key = jax.random.PRNGKey(0)
    init_key = jax.random.fold_in(key, jengine._SIM_SALT + 1)
    keys = [jax.random.split(k, 4) for k in jax.random.split(
        jax.random.fold_in(key, jengine._SIM_SALT), ROUNDS)]
    pcfg = SCENARIOS["cluster-churn"].channel
    step = jax.jit(lambda s, k: jproc.step_channel(s, pcfg, tcfg, k))
    view = jax.jit(lambda s: jproc.channel_view(s, tcfg))
    chan = jproc.init_channel(topo, tcfg, init_key)
    draws, firsts, heads = [], [], {"eager": [], "jitted": []}
    for t in range(ROUNDS):
        k_chan, _, _, k_cluster = keys[t]
        k_fade, k_shadow, k_way = jax.random.split(k_chan, 3)
        k_re, k_im = jax.random.split(k_fade)
        draws.append({
            "fade_re": np.asarray(erf_inv_draw(k_re, (K, K))).tolist(),
            "fade_im": np.asarray(erf_inv_draw(k_im, (K, K))).tolist(),
            "shadow": np.asarray(erf_inv_draw(k_shadow, (K, K))).tolist(),
            "waypoints": np.asarray(jax.random.uniform(k_way,
                                                       (K, 2))).tolist()})
        firsts.append(int(jax.random.randint(k_cluster, (), 0, K)))
        chan = step(chan, k_chan)
        v = view(chan)
        if t % SCENARIOS["cluster-churn"].recluster_every == 0:
            plan = functools.partial(jcl.make_cluster_plan,
                                     num_clusters=C, key=k_cluster)
            heads["eager"].append([int(h) for h in plan(
                v.link_snr, v.adjacency).heads])
            heads["jitted"].append([int(h) for h in jax.jit(plan)(
                v.link_snr, v.adjacency).heads])
    gain = np.asarray(topo.link_gain)
    OUT.write_text(json.dumps({
        "topology_seed": SEED, "K": K, "C": C, "rounds": ROUNDS,
        "positions": np.asarray(topo.positions).tolist(),
        "link_gain_re": gain.real.tolist(),
        "link_gain_im": gain.imag.tolist(),
        "waypoints0": np.asarray(jax.random.uniform(init_key,
                                                    (K, 2))).tolist(),
        "channel": draws, "recluster_first": firsts,
        "heads_eager": heads["eager"], "heads_jitted": heads["jitted"],
        "jax": jax.__version__}) + "\n")
    print(OUT, heads)


if __name__ == "__main__":
    main()
