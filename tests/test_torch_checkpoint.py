"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's (`repro.checkpoint`): the same on-disk layout, so a params tree
saved by either loads into the other bit for bit, bf16 included (its
uint16 bit patterns on the wire, ``"bfloat16"`` recorded)."""
import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.models import small as jsmall
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    read_checkpoint, save_checkpoint)
from repro_torch.convert import params_from_jax


def _tree(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 3, generator=g).to(dtype),
            "b": torch.arange(3, dtype=torch.float32).to(dtype),
            "step": torch.tensor(7, dtype=torch.int64)}


def _zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _bits(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return np.atleast_1d(x.numpy()).view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_round_trip_is_bitwise(tmp_path, dtype):
    t = _tree(dtype)
    if dtype == torch.bfloat16:
        t["w"][0, 0] = 3.0e38     # near bf16's top: a value cast would
        t["w"][0, 1] = float("nan")  # overflow, and NaN keeps its bits
    save_checkpoint(tmp_path, 3, t)
    r = load_checkpoint(tmp_path, _zeros_like(t))
    for k in t:
        assert r[k].dtype == t[k].dtype
        np.testing.assert_array_equal(_bits(r[k]), _bits(t[k]))
    meta = json.loads((tmp_path / "step_00000003" / "tree.json").read_text())
    raw = np.load(tmp_path / "step_00000003" / "arrays.npz")
    if dtype == torch.bfloat16:
        assert meta["dtypes"]["w"] == "bfloat16"
        assert raw["w"].dtype == np.uint16
    assert meta["names"] == ["b", "step", "w"]      # JAX's sorted order


def test_nests_name_their_leaves_as_jax(tmp_path):
    """Dict keys, list indices, and ``.field`` for a named tuple's or a
    dataclass's field, joined by ``/`` as JAX's ``_flatten_with_names``
    joins them; constants (numbers, None) are not leaves."""
    NT = collections.namedtuple("NT", "a b")

    @dataclasses.dataclass(frozen=True)
    class DC:
        x: torch.Tensor
        n: int = 3

    tree = {"p": NT(torch.ones(2), [torch.zeros(1), None]),
            "q": (torch.full((), 2.0),), "r": DC(torch.arange(4)), "s": 5}
    save_checkpoint(tmp_path, 0, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"p": NT(jnp.ones(2), [jnp.zeros(1), None]),
         "q": (jnp.full((), 2.0),)})
    jax_names = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path) for path, _ in flat]
    names = list(read_checkpoint(tmp_path))
    assert names[:3] == jax_names == ["p/.a", "p/.b/0", "q/0"]
    assert names[3:] == ["r/.x"]
    back = load_checkpoint(tmp_path, {
        "p": NT(torch.empty(2), [torch.empty(1), None]),
        "q": (torch.empty(()),), "r": DC(torch.empty(4, dtype=torch.int64)),
        "s": 5})
    assert back["r"].n == 3 and back["s"] == 5 and back["p"].b[1] is None
    assert torch.equal(back["r"].x, torch.arange(4))


def test_latest_step_and_an_explicit_step(tmp_path):
    t = _tree()
    assert latest_step(tmp_path / "nowhere") is None
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 4, {k: v + 1 for k, v in t.items()})
    assert latest_step(tmp_path) == 4
    r1 = load_checkpoint(tmp_path, t, step=1)
    r4 = load_checkpoint(tmp_path, t)
    assert torch.equal(r1["b"], t["b"]) and torch.equal(r4["b"], t["b"] + 1)


def test_errors_name_the_leaf_and_the_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        load_checkpoint(tmp_path, _tree())
    (tmp_path / "step_00000002").mkdir()
    with pytest.raises(FileNotFoundError, match="step_00000002"):
        load_checkpoint(tmp_path, _tree(), step=2)
    t = _tree()
    save_checkpoint(tmp_path, 5, t)
    with pytest.raises(ValueError, match=r"w.*step_00000005"):
        load_checkpoint(tmp_path, dict(t, w=torch.zeros(2, 2)), step=5)
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(tmp_path, dict(t, extra=torch.zeros(())), step=5)


def test_load_restores_onto_the_template_dtype(tmp_path):
    """Like JAX's ``jnp.asarray(arr, dtype=leaf.dtype)``: the template's
    dtype wins (an f32 checkpoint into a bf16 template rounds once)."""
    t = _tree()
    save_checkpoint(tmp_path, 0, t)
    r = load_checkpoint(tmp_path, {k: v.to(torch.bfloat16) if k != "step"
                                   else v for k, v in t.items()})
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"], t["w"].to(torch.bfloat16))


@pytest.fixture(scope="module")
def jax_params():
    init, _ = jsmall.make_mnist_mlp(hidden=(16,))
    return init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_params, dtype):
    tree = jax.tree.map(lambda x: x.astype(dtype), jax_params)
    jax_save(tmp_path, 2, tree)
    template = params_from_jax(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), tree), device="cpu")
    template = {k: {n: v.to(getattr(torch, dtype)) for n, v in sub.items()}
                for k, sub in template.items()}
    got = load_checkpoint(tmp_path, template)
    for k, sub in tree.items():
        for n, want in sub.items():
            x = got[k][n]
            assert str(x.dtype) == f"torch.{dtype}"
            np.testing.assert_array_equal(
                _bits(x), np.atleast_1d(np.asarray(want)).view(
                    np.int16 if dtype == "bfloat16" else np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_into_jax(tmp_path, jax_params, dtype):
    g = torch.Generator().manual_seed(1)
    tree = {k: {n: torch.randn(v.shape, generator=g).to(getattr(torch, dtype))
                for n, v in sub.items()} for k, sub in jax_params.items()}
    save_checkpoint(tmp_path, 7, tree)
    template = jax.tree.map(lambda x: jnp.zeros(x.shape, dtype), jax_params)
    got = jax_load(tmp_path, template)
    for k, sub in tree.items():
        for n, want in sub.items():
            x = np.asarray(got[k][n])
            assert str(x.dtype) == dtype
            np.testing.assert_array_equal(
                np.atleast_1d(x).view(np.int16 if dtype == "bfloat16"
                                      else np.uint8), _bits(want))
