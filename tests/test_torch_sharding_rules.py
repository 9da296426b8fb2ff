"""`repro_torch.dist.sharding_rules` against `repro.dist.sharding_rules`
on JAX's own fake production meshes, (data, model) = (16, 16) and (pod,
data, model) = (2, 16, 16): the fit, and the specs of every parameter,
batch and decode-cache leaf of the ten registered configurations (JAX's
from ``jax.eval_shape``, the port's from its ``meta`` device); the
placements on a one-rank gloo `DeviceMesh`; ``--devices`` of
`examples/run_scenario_torch.py`; the pytree helpers; and the
configuration knobs the port keeps for JAX's field set."""
import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import sharding_rules as jsr
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist import sharding_rules as sr
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (no devices needed)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _entries(spec) -> tuple:
    return tuple(spec)


@settings(deadline=None, max_examples=50)
@given(dim=st.integers(1, 4096), seed=st.integers(0, 3))
def test_fit_dim_matches_jax_and_divides(dim, seed):
    axes = [("model",), ("data",), ("pod", "data"), ("data", "model")][seed]
    axes = tuple(a for a in axes if a in MESH2.shape)
    got = sr._fit_dim(dim, axes, MESH2)
    assert got == jsr._fit_dim(dim, axes, MESH2)
    if got is not None:
        names = got if isinstance(got, tuple) else (got,)
        assert dim % int(np.prod([MESH2.shape[a] for a in names])) == 0


def test_fit_spec_drops_pod_first_and_never_reuses_an_axis():
    assert sr.fit_spec((16, 64), (sr.FSDP, "model"), MESH2) == sr.Spec(
        "data", "model")
    assert sr.fit_spec((32, 64), (sr.FSDP, "model"), MESH2) == sr.Spec(
        ("pod", "data"), "model")
    assert sr.fit_spec((32, 32), ("model", "model"), MESH1) == sr.Spec(
        "model", None)
    for shape, want in (((16, 64), (jsr.FSDP, "model")),
                        ((32, 32), ("model", "model")),
                        ((7, 48, 3), (jsr.BATCH, None, "model"))):
        for mesh in (MESH1, MESH2):
            assert _entries(sr.fit_spec(shape, want, mesh)) == _entries(
                jsr.fit_spec(shape, want, mesh))


def _flat_specs(tree, prefix=()):
    """(path, entries) of a spec tree, JAX's or the port's."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_specs(tree[k], prefix + (k,))
        return out
    return [(prefix, _entries(tree))]


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_jax_for_every_leaf(arch, mesh):
    from repro.configs import get_config as jget
    from repro.models.config import InputShape as JShape
    from repro.models import inputs as jinputs
    from repro.models import transformer as jtfm

    jcfg = jget(arch)
    cfg = get_config(arch)
    jshapes = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = _flat_specs(jsr.param_specs(jshapes, mesh))
    got = _flat_specs(sr.param_specs(dryrun._meta_params(cfg), mesh))
    assert got == want
    jbatch = jinputs.train_batch_specs(jcfg, JShape("s", 64, 32, "train"))
    assert _flat_specs(sr.batch_specs(dryrun.batch_specs(
        cfg, 64, 32, "train"), mesh)) == _flat_specs(
            jsr.batch_specs(jbatch, mesh))
    jcache = jtfm.decode_cache_specs(jcfg, 32, 256)
    assert _flat_specs(sr.cache_specs(dryrun.decode_cache_specs(
        cfg, 32, 256), mesh)) == _flat_specs(jsr.cache_specs(jcache, mesh))


def test_trajectory_and_client_specs_match_jax():
    for n, mesh in ((8, {"mc": 4}), (6, {"mc": 4}), (12, {"clients": 3})):
        fm = FakeMesh(mesh)
        x = jax.ShapeDtypeStruct((n, 5), jnp.float32)
        t = torch.empty(n, 5, device="meta")
        assert _entries(sr.trajectory_specs(t, fm)) == _entries(
            jsr.trajectory_specs(x, fm))
        assert _entries(sr.client_specs(t, fm)) == _entries(
            jsr.client_specs(x, fm))
    assert sr.shard_size(sr.Spec("mc"), 0, 8, {"mc": 4}) == 2
    assert sr.shard_size(sr.Spec(None), 0, 6, {"mc": 4}) == 6


def test_placements_round_trip_on_a_one_rank_device_mesh(tmp_path):
    """A full-width configuration's param specs on a one-rank gloo
    `DeviceMesh` (data, model): each leaf through `distribute_tensor`
    and back by `full_tensor` bitwise, its placements the spec's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        assert sr.placements(sr.Spec("model", "data"), mesh) == [
            Shard(1), Shard(0)]
        assert sr.placements(sr.Spec(None, None), mesh) == [Replicate(),
                                                            Replicate()]
        pod = init_device_mesh("cpu", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
        assert sr.placements(sr.Spec(("pod", "data"), "model"), pod) == [
            Shard(0), Shard(0), Shard(1)]
        with pytest.raises(ValueError, match="order"):
            sr.placements(sr.Spec(("data", "pod")), pod)
        cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=1)
        meta = dryrun._meta_params(cfg)
        specs = sr.param_specs(meta, mesh)
        g = torch.Generator().manual_seed(0)
        for (path, spec), (_, leaf) in zip(_flat_specs(specs),
                                           _flat_leaves(meta)):
            # A corner of each leaf: one rank's mesh divides any length.
            x = torch.randn(tuple(min(n, 256) for n in leaf.shape),
                            generator=g)
            d = distribute_tensor(x, mesh, sr.placements(
                sr.Spec(*spec), mesh))
            assert torch.equal(d.full_tensor(), x), path
    finally:
        dist.destroy_process_group()


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("devices", [1, 2])
def test_run_scenario_devices_on_a_world_of_one(monkeypatch, tmp_path,
                                                capsys, devices):
    """``--devices 1`` runs the sharded sweep on the one rank; ``--devices
    2`` on a world of one is an error that says so."""
    out = tmp_path / "run.json"
    monkeypatch.setattr(sys, "argv", [
        "run_scenario_torch.py", "--device", "cpu", "--shard", "mc",
        "--seeds", "2", "--rounds", "2", "--clients", "4", "--train", "320",
        "--test", "64", "--hidden", "8", "--devices", str(devices),
        "--out", str(out)])
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path = str(ROOT / "examples" / "run_scenario_torch.py")
    if devices == 1:
        runpy.run_path(path, run_name="__main__")
        assert "ranks=1 of 1" in capsys.readouterr().out
        assert out.exists()
    else:
        with pytest.raises(SystemExit):
            runpy.run_path(path, run_name="__main__")
        assert "--devices 2: the process group has 1 rank" in (
            capsys.readouterr().err)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_pytree_helpers_match_jax():
    """The six helpers of `repro.utils` on the same trees: the elementwise
    ones bitwise, the norms to f32 rounding."""
    from repro import utils as ju
    from repro_torch import utils as tu
    from repro_torch.convert import params_from_jax

    rng = np.random.default_rng(0)

    def tree():
        return {"fc0": {"w": rng.standard_normal((33, 17)).astype(
            np.float32), "b": rng.standard_normal(17).astype(np.float32)},
                "out": rng.standard_normal((5,)).astype(np.float32)}

    a, b, c = tree(), tree(), tree()
    ta, tb, tc = (params_from_jax(t, device="cpu") for t in (a, b, c))
    ja, jb, jc = (jax.tree.map(jnp.asarray, t) for t in (a, b, c))

    def same(got, want):
        for x, y in zip(tu.tree_leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(x.numpy(), np.asarray(y))

    same(tu.tree_add(ta, tb), ju.tree_add(ja, jb))
    same(tu.tree_scale(ta, 0.3), ju.tree_scale(ja, 0.3))
    same(tu.tree_zeros_like(ta), ju.tree_zeros_like(ja))
    same(tu.tree_weighted_sum([ta, tb, tc], [0.2, 0.5, 0.3]),
         ju.tree_weighted_sum([ja, jb, jc], [0.2, 0.5, 0.3]))
    np.testing.assert_allclose(float(tu.tree_sq_norm(ta)),
                               float(ju.tree_sq_norm(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(tu.tree_l2_norm(ta)),
                               float(ju.tree_l2_norm(ja)), rtol=1e-6)


@pytest.mark.parametrize("knob,value", [("scan_layers", False),
                                        ("unroll_loops", True),
                                        ("act_spec", ("data", None,
                                                      "model"))])
def test_jax_knobs_change_nothing_the_port_computes(knob, value):
    """``scan_layers``, ``unroll_loops`` and ``act_spec`` steer JAX's
    lowering and sharding; the port keeps them for JAX's field set, and
    a reduced forward with each flipped is bitwise the same."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.inputs import make_batch

    cfg = get_config("qwen2.5-3b", reduced=True)
    params = tfm.init_params(0, cfg, device="cpu")
    batch = make_batch(1, cfg, 16, 2, device="cpu")
    logits, aux = tfm.forward(params, batch, cfg)
    logits2, aux2 = tfm.forward(params, batch, cfg.replace(**{knob: value}))
    assert torch.equal(logits2, logits)
    assert torch.equal(torch.as_tensor(aux2), torch.as_tensor(aux))
