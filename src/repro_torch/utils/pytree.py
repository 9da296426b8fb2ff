"""Parameter-tree helpers: nested dicts of tensors, in JAX's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order, so an MLP's leaves
come out ``fc0.b, fc0.w, fc1.b, fc1.w, ...``.  The flat ``(K, d)`` round
matrix (`repro_torch.core.cwfl._flat_pack`) is laid out in that order, so
one ``(C, d)`` noise matrix means the same thing to both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import torch

Tree = Any   # a tensor, or a dict of Trees


def tree_flatten(tree: Tree) -> tuple[list[torch.Tensor], Any]:
    """``(leaves, treedef)`` with dict keys visited in sorted order."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for key in sorted(tree):
            sub_leaves, sub_def = tree_flatten(tree[key])
            leaves.extend(sub_leaves)
            defs.append((key, sub_def, len(sub_leaves)))
        return leaves, tuple(defs)
    if isinstance(tree, torch.Tensor):
        return [tree], None
    raise TypeError(f"parameter trees hold dicts and tensors, got "
                    f"{type(tree).__name__}")


def tree_unflatten(treedef: Any, leaves: list[torch.Tensor]) -> Tree:
    """Inverse of :func:`tree_flatten`."""
    if treedef is None:
        (leaf,) = leaves
        return leaf
    out, off = {}, 0
    for key, sub_def, n in treedef:
        out[key] = tree_unflatten(sub_def, leaves[off:off + n])
        off += n
    return out


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` applied leaf by leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def tree_size(tree: Tree) -> int:
    """Total number of scalars d = dim(θ)."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_add_noise(tree: Tree, sigma,
                   noise: Union[torch.Generator, Sequence[torch.Tensor]]
                   ) -> Tree:
    """tree + w, w ~ N(0, sigma² I), elementwise over every leaf.
    ``noise``: one unit-normal tensor per leaf, in leaf order (JAX draws
    ``normal(k, x.shape, x.dtype)`` with one key a leaf), or a
    ``torch.Generator`` to draw them from."""
    leaves, treedef = tree_flatten(tree)
    if isinstance(noise, torch.Generator):
        noise = [torch.randn(x.shape, generator=noise, dtype=x.dtype,
                             device=x.device) for x in leaves]
    if len(noise) != len(leaves):
        raise ValueError(f"{len(noise)} noise tensors for {len(leaves)} "
                         f"leaves")
    return tree_unflatten(treedef, [x + sigma * n.to(x.dtype)
                                    for x, n in zip(leaves, noise)])


def tree_flatten_vector(tree: Tree) -> torch.Tensor:
    """One 1-D vector of every leaf, in leaf order (for OTA transmission)."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def tree_unflatten_vector(vec: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`tree_flatten_vector` given a template tree: each
    leaf takes its template's shape and dtype.  Leading axes of ``vec``
    are kept: a (C, d) matrix gives leaves of shape (C,) + the
    template's."""
    leaves, treedef = tree_flatten(like)
    out, off = [], 0
    for x in leaves:
        n = x.numel()
        out.append(vec[..., off:off + n].reshape(vec.shape[:-1] + x.shape)
                   .to(x.dtype))
        off += n
    return tree_unflatten(treedef, out)
