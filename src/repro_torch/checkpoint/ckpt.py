"""Checkpointing: npz-based saves of nests of tensors with step management
(port of `repro.checkpoint.ckpt`, on JAX's on-disk layout).

Layout: ``<dir>/step_<%08d>/arrays.npz`` + ``tree.json`` (leaf names,
dtypes).  A leaf's name joins its path with ``/`` as JAX's
``_flatten_with_names`` joins it: a dict key (keys in sorted order), a
list or tuple index, ``.field`` for a named tuple's or a dataclass's
field.  So a parameter tree saved by either package loads into the other.
A nest's non-tensor leaves (``None``, numbers, configs) are constants of
its structure and are not saved.

bfloat16 leaves are stored as their raw uint16 bit patterns with
``"bfloat16"`` recorded in ``tree.json``, as JAX's ``_WIRE_DTYPES`` does
(``np.savez`` has no bfloat16): a reinterpreting view on both sides,
never a value conversion, so a checkpoint restores bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _named(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every tensor of ``tree``, in JAX's leaf order
    and with its leaf names."""
    def sub(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        yield prefix or "_root", tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], sub(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _named(getattr(tree, f), sub(f".{f}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named(v, sub(i))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _named(getattr(tree, f.name), sub(f".{f.name}"))


def _rebuild(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each tensor replaced by ``fn(name, tensor)``."""
    def sub(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        return fn(prefix or "_root", tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, sub(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, sub(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), fn, sub(f".{f.name}"))
            for f in dataclasses.fields(tree)})
    return tree


def _to_numpy(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array the npz stores, the leaf's true dtype)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = x.numpy()
    return arr, str(arr.dtype)


def _structure(tree) -> str:
    """A readable outline of the nest (``tree.json``'s ``treedef``)."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(getattr(tree, f))}" for f in tree._fields)
            + ")")
    if isinstance(tree, (tuple, list)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f.name}={_structure(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")")
    return repr(tree)


def save_checkpoint(directory, step: int, tree: Any) -> Path:
    """Write ``tree``'s tensors under ``<directory>/step_<step>`` and return
    that directory."""
    d = Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    wire, dtypes = {}, {}
    for name, x in _named(tree):
        wire[name], dtypes[name] = _to_numpy(x)
    np.savez(d / "arrays.npz", **wire)
    meta = {"step": step, "treedef": _structure(tree),
            "names": list(wire), "dtypes": dtypes}
    (d / "tree.json").write_text(json.dumps(meta))
    return d


def _step_dir(directory: Path, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    if not (d / "arrays.npz").exists():
        raise FileNotFoundError(f"checkpoint step directory {d} has no "
                                f"arrays.npz (is step {step} complete?)")
    return d


def read_checkpoint(directory, step: Optional[int] = None
                    ) -> dict[str, torch.Tensor]:
    """Every leaf of a checkpoint by name, as CPU tensors of their true
    dtypes (the latest step unless ``step`` is given)."""
    d = _step_dir(Path(directory), step)
    meta_path = d / "tree.json"
    saved = (json.loads(meta_path.read_text()).get("dtypes", {})
             if meta_path.exists() else {})
    with np.load(d / "arrays.npz") as data:
        return {name: _from_wire(data[name], saved.get(name))
                for name in data.files}


def _from_wire(arr: np.ndarray, true_dtype: Optional[str]) -> torch.Tensor:
    if true_dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_checkpoint(directory, template: Any, step: Optional[int] = None
                    ) -> Any:
    """Load into the structure of ``template``: each tensor restored onto
    the template's device and dtype, its shape validated (the latest step
    unless ``step`` is given).  Errors name the leaf and the directory."""
    directory = Path(directory)
    d = _step_dir(directory, step)
    leaves = read_checkpoint(directory, int(d.name.removeprefix("step_")))

    def restore(name: str, leaf: torch.Tensor) -> torch.Tensor:
        if name not in leaves:
            raise KeyError(f"{name}: missing from {d / 'arrays.npz'} — "
                           f"template does not match this checkpoint")
        x = leaves[name]
        if tuple(x.shape) != tuple(leaf.shape):
            raise ValueError(f"{name} (in {d}): checkpoint shape "
                             f"{tuple(x.shape)} != template "
                             f"{tuple(leaf.shape)}")
        return x.to(device=leaf.device, dtype=leaf.dtype)

    return _rebuild(template, restore)


def latest_step(directory) -> Optional[int]:
    """The highest saved step in ``directory``, or ``None``."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None
