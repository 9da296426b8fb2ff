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


def tree_add(a: Tree, b: Tree) -> Tree:
    """``a + b`` leaf by leaf."""
    la, treedef = tree_flatten(a)
    return tree_unflatten(treedef, [x + y for x, y in zip(la,
                                                          tree_leaves(b))])


def tree_scale(a: Tree, s) -> Tree:
    """Every leaf times ``s``."""
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_weighted_sum(trees: Sequence[Tree], weights) -> Tree:
    """Σᵢ weights[i]·trees[i], summed in order from 0 as JAX's (``weights``
    as an f32 tensor unless given as a tensor)."""
    if not torch.is_tensor(weights):
        weights = torch.as_tensor(weights, dtype=torch.float32)
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    out = []
    for leaves in zip(*(f[0] for f in flat)):
        acc = 0
        for w, x in zip(weights.to(leaves[0].device), leaves):
            acc = acc + w * x
        out.append(acc)
    return tree_unflatten(treedef, out)


def tree_sq_norm(a: Tree) -> torch.Tensor:
    """Σ over the leaves of Σ x², each leaf in f32."""
    return sum(torch.sum(torch.square(x.to(torch.float32)))
               for x in tree_leaves(a))


def tree_l2_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


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
