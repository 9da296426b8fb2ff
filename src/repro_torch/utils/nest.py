"""Nests of tensors: dicts (in key order), tuples, named tuples, lists and
dataclasses, with anything else a constant of the nest.

The engine's carries, draws and strategy states are such nests.  A
Monte-Carlo sweep stacks B trajectories' nests along a leading axis
(:func:`nest_stack`) and maps a per-trajectory function over them with
``torch.func.vmap`` (:func:`nest_vmap`), which itself maps only tensors
and containers of them, not dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


def nest_tensors(obj) -> list:
    """The tensors of a nest, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in nest_tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in nest_tensors(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in nest_tensors(getattr(obj, f.name))]
    return []


def nest_rebuild(obj, tensors):
    """``obj`` with its tensors (:func:`nest_tensors`' order) taken from the
    iterator ``tensors``."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if isinstance(obj, dict):
        out = {k: nest_rebuild(obj[k], tensors) for k in sorted(obj)}
        return {k: out[k] for k in obj}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(nest_rebuild(v, tensors) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(nest_rebuild(v, tensors) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: nest_rebuild(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj)})
    return obj


def nest_map(fn: Callable, obj):
    """``obj`` with ``fn`` applied to each of its tensors."""
    return nest_rebuild(obj, iter([fn(x) for x in nest_tensors(obj)]))


def nest_stack(nests: Sequence):
    """Nests of one structure as one, each tensor stacked along a new
    leading axis; the constants are the first nest's."""
    columns = zip(*(nest_tensors(x) for x in nests))
    return nest_rebuild(nests[0], iter([torch.stack(c) for c in columns]))


def nest_vmap(fn: Callable, *args):
    """``torch.func.vmap(fn)`` over nests: every tensor of every argument
    is mapped along its leading axis, the constants (``None``, numbers,
    configs) are passed as they are, and the result is a nest of
    ``fn``'s structure with a leading axis on each tensor.  ``fn`` must
    be a pure function of tensors: no host sync, no Python branch on a
    tensor's value."""
    counts = [len(nest_tensors(a)) for a in args]
    shape_of_result = []

    def flat_fn(*tensors):
        it = iter(tensors)
        out = fn(*(nest_rebuild(a, iter([next(it) for _ in range(n)]))
                   for a, n in zip(args, counts)))
        shape_of_result.append(out)
        # vmap needs a tensor out; a result without one is a constant.
        return (torch.zeros(()),) + tuple(nest_tensors(out))

    flat = [x for a in args for x in nest_tensors(a)]
    _, *outs = torch.func.vmap(flat_fn)(*flat)
    return nest_rebuild(shape_of_result[-1], iter(outs))
