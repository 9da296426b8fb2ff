"""Mesh-shape-aware sharding specs, and their `torch.distributed.tensor`
placements.

Port of `repro.dist.sharding_rules`.  The rules are logic on shapes: the
production meshes are (data, model) = (16, 16) or (pod, data, model) =
(2, 16, 16), and every rule is fitted to the mesh's shape.

* ``FSDP`` / ``BATCH`` are axis aliases that expand to the fully-sharded
  axis group of the mesh (``("pod", "data")`` when a pod axis exists,
  else ``("data",)``); ``MC`` and ``CLIENTS`` name the sweep's trajectory
  axis and the stacked client axis of `repro_torch.sim.sharded`.
* `_fit_dim` drops leading axes (pod first) until the remaining group's
  size divides the dimension; a dim nothing divides stays replicated.
* `fit_spec` never reuses an axis across the dims of one leaf.

A mesh is anything with ``axis_names`` and a ``shape`` mapping (JAX's
duck-typed meshes), a ``{name: size}`` dict, or a `DeviceMesh` with
``mesh_dim_names``.  A spec is a `Spec`, a tuple with one entry a tensor
dim: ``None`` (replicated), an axis name, or a tuple of names, the major
axis first.  `placements` turns one into the ``Shard``/``Replicate`` list
of a `DeviceMesh` (`distribute_tensor`), where JAX's ``named`` makes a
``NamedSharding``.

``param_specs`` / ``batch_specs`` / ``cache_specs`` apply the rules to
every leaf of the port's parameter, input-batch and decode-cache trees,
whose key paths are JAX's (`repro_torch.convert.params_from_jax`);
``trajectory_specs`` / ``client_specs`` fit the sweep's and the
client-sharded run's process groups.
"""
from __future__ import annotations

import math

# Axis aliases, resolved against the mesh at fit time.
FSDP = "__fsdp__"        # fully-sharded parameter dim: ("pod", "data")
BATCH = "__batch__"      # data-parallel batch dim:     ("pod", "data")
MC = "__mc__"            # Monte-Carlo trajectory dim:  ("mc",)
CLIENTS = "__clients__"  # stacked FL client dim:       ("clients",)

_ALIAS_AXES = ("pod", "data")


class Spec(tuple):
    """A per-dim sharding spec: ``Spec("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh, in the mesh's axis order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {name: dict(mesh.shape)[name] for name in mesh.axis_names}


def _axes_for(entry, mesh) -> tuple:
    """Expand a spec entry (None / name / tuple / alias) to mesh axes."""
    if entry is None:
        return ()
    if entry in (FSDP, BATCH):
        cand = _ALIAS_AXES
    elif entry == MC:
        cand = ("mc",)
    elif entry == CLIENTS:
        cand = ("clients",)
    elif isinstance(entry, tuple):
        cand = entry
    else:
        cand = (entry,)
    sizes = _mesh_sizes(mesh)
    return tuple(a for a in cand if a in sizes)


def _fit_dim(dim: int, axes: tuple, mesh):
    """Largest suffix of ``axes`` whose total mesh size divides ``dim``:
    a bare axis name, a tuple of names, or None (replicate)."""
    sizes = _mesh_sizes(mesh)
    axes = tuple(axes)
    while axes:
        total = math.prod(sizes[a] for a in axes)
        if total > 0 and dim % total == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]
    return None


def fit_spec(shape: tuple, want: tuple, mesh) -> Spec:
    """Fit the requested per-dim axes to ``shape`` on ``mesh``: entries
    None, an axis name, a tuple of names or an alias; missing trailing
    entries are None; an axis consumed by an earlier dim is not reused."""
    want = tuple(want) + (None,) * (len(shape) - len(want))
    used: set = set()
    parts = []
    for dim, entry in zip(shape, want):
        axes = tuple(a for a in _axes_for(entry, mesh) if a not in used)
        fitted = _fit_dim(dim, axes, mesh) if axes else None
        if fitted is not None:
            used.update(fitted if isinstance(fitted, tuple) else (fitted,))
        parts.append(fitted)
    return Spec(*parts)


# ---------------------------------------------------------------------------
# Tree-level rules.
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, the path
    as JAX's key strings (a list index as ``[i]``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def _param_want(keys: tuple, shape: tuple) -> tuple:
    """Per-leaf sharding intent, before fitting: ``embed`` vocab over
    ``model`` and d_model over FSDP; an MoE expert stack (E, d_in, d_out)
    E over FSDP and its outputs over ``model``; any other matrix its
    inputs over FSDP and outputs over ``model``; vectors replicated.  A
    leaf under ``layers`` has a leading period axis, replicated."""
    name = keys[-1]
    stacked = "layers" in keys[:-1]
    core = shape[1:] if stacked else shape
    if name == "embed":
        want: tuple = ("model", FSDP)
    elif "moe" in keys and len(core) == 3:
        want = (FSDP, None, "model")
    elif len(core) >= 2:
        want = (None,) * (len(core) - 2) + (FSDP, "model")
    else:
        want = (None,) * len(core)
    return ((None,) + want) if stacked else want


def param_specs(params, mesh):
    """A `Spec` for every parameter leaf (tensors, ``meta`` ones too)."""
    return _map_with_path(lambda path, leaf: fit_spec(
        _shape(leaf), _param_want(path, _shape(leaf)), mesh), params)


def batch_specs(batch, mesh):
    """Batch leaves: the leading (global-batch) dim over the BATCH group,
    the rest replicated (a batch of 1 stays replicated by the fit)."""
    return _map_with_path(lambda _, leaf: fit_spec(
        _shape(leaf), (BATCH,), mesh), batch)


def cache_specs(caches, mesh):
    """Decode-cache leaves ``(periods, B, ..., feature)``: B over the
    BATCH group, the trailing feature dim over ``model`` when the leaf
    has four dims or more, the rest replicated."""
    def one(_, leaf):
        n = len(_shape(leaf))
        if n >= 4:
            want = (None, BATCH) + (None,) * (n - 3) + ("model",)
        else:
            want = (None, BATCH) + (None,) * max(n - 2, 0)
        return fit_spec(_shape(leaf), want[:n], mesh)
    return _map_with_path(one, caches)


def trajectory_specs(shapes, mesh):
    """Sweep leaves ``(N_traj, ...)``: the trajectory dim over ``mc``."""
    return _map_with_path(lambda _, leaf: fit_spec(
        _shape(leaf), (MC,), mesh), shapes)


def client_specs(shapes, mesh):
    """Stacked-client leaves ``(K, ...)``: the client dim over
    ``clients`` (one shard = K/n clients)."""
    return _map_with_path(lambda _, leaf: fit_spec(
        _shape(leaf), (CLIENTS,), mesh), shapes)


def shard_size(spec: Spec, dim: int, length: int, mesh) -> int:
    """The length of one shard of tensor dim ``dim`` (of ``length``) under
    ``spec`` on ``mesh``."""
    entry = spec[dim] if dim < len(spec) else None
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    sizes = _mesh_sizes(mesh)
    return length // math.prod(sizes[a] for a in names)


def placements(spec: Spec, device_mesh) -> list:
    """The `torch.distributed.tensor` placements of ``spec`` on
    ``device_mesh`` (its dims named as the spec's axes), one a mesh dim:
    ``Shard(d)`` where tensor dim d is split over it, else
    ``Replicate()``.  A tuple of axes on one dim is one ``Shard(d)`` a
    mesh dim, which DTensor nests in mesh order, so the tuple must list
    them in mesh order: the major axis first, as JAX's order is."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"the axes {axes} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out
