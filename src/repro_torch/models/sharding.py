"""Placement: parameter and activation sharding over a device mesh
(counterpart of ``repro.models.sharding``).

Models stay mesh-agnostic.  A launcher installs a mesh (``set_mesh``), a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``;
models call ``constrain(x, *spec)`` at the few places that matter
(post-embed, attention output, FFN intermediate, logits).  Off a mesh, and
on a plain tensor, ``constrain`` is the identity, so every single-device
path runs unchanged.

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over all of them, the first named the major split, as JAX splits a
``PartitionSpec`` entry).  The entry ``"batch"`` resolves to
``batch_axes()``.  ``placements`` turns a spec into DTensor placements and
``place`` distributes a tree of tensors, real or fake, by a tree of specs:
the torch form of the reference's ``NamedSharding`` plus its device put.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install ``mesh`` (a ``DeviceMesh``, or None to leave the mesh)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    return _ACTIVE_MESH


def batch_axes(mesh=None) -> tuple:
    """The axes that jointly play the data-parallel role: ("pod", "data")
    under a multi-pod mesh, ("data",) otherwise and off a mesh."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def named(*spec) -> tuple:
    """A spec from its entries, ``None`` spelled as the empty tuple (the
    reference's ``named``: both mean replicated)."""
    return tuple(() if s is None else s for s in spec)


def _axes(entry) -> tuple:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh dimension that the spec names at tensor dimension ``dim``,
    ``Replicate()`` on the others.  A dimension split over several axes
    must name them in the mesh's order (DTensor splits the earlier mesh
    dimension first, the major split)."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = batch_axes(mesh) if entry == "batch" else _axes(entry)
        pos = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            pos.append(names.index(a))
            out[names.index(a)] = Shard(dim)
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} must name its axes in mesh order {names}")
    return out


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to ``spec`` on the active mesh; the
    identity on a plain tensor and when no mesh is set."""
    if _ACTIVE_MESH is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(_ACTIVE_MESH, placements(_ACTIVE_MESH, spec))


def place(tree: Any, spec_tree: Any, mesh=None) -> Any:
    """Distribute a tree (dicts and lists) of tensors, real or fake, to
    DTensors on ``mesh`` (None: the active mesh) by the same-shaped tree of
    specs.  Each rank keeps only its own block and nothing is communicated;
    under ``FakeTensorMode`` nothing is allocated."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None:
        raise ValueError("place needs a mesh: pass one or set_mesh() first")

    def go(t, s):
        if isinstance(t, torch.Tensor):
            return distribute_tensor(t, mesh, placements(mesh, s), src_data_rank=None)
        if isinstance(t, dict):
            return {k: go(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, sv) for v, sv in zip(t, s, strict=True))
        raise TypeError(f"cannot place a {type(t).__name__}")

    return go(tree, spec_tree)


def local_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree of (D)Tensors: each DTensor's local
    block, each plain tensor whole."""
    if isinstance(tree, DTensor):
        local = tree.to_local()
        return local.numel() * local.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0
