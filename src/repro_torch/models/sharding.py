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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

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


def _like(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` (plain or DTensor) as a DTensor of ``placements`` on ``mesh``."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def block(shape, mesh, placements, coordinate=None) -> tuple:
    """(local shape, global offset) of this rank's block (or the block at
    ``coordinate`` on the mesh) of a tensor of ``shape`` placed by
    ``placements``: each mesh dimension that shards a tensor dimension
    splits the block left so far as ``torch.chunk`` does, the earlier mesh
    dimension first (DTensor's layout), in plain integers."""
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    local, offset = list(shape), [0] * len(shape)
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n, size = mesh.size(mdim), local[p.dim]
            piece = -(-size // n)
            start = min(coord[mdim] * piece, size)
            local[p.dim] = min(start + piece, size) - start
            offset[p.dim] += start
    return tuple(local), tuple(offset)


def write_rows(cache: torch.Tensor, pos: torch.Tensor, value: torch.Tensor) -> None:
    """``cache[b, pos[b]] = value[b]`` for every row b, in place: ``cache``
    (B, S, ...), ``pos`` (B,) int, ``value`` (B, ...).

    On a DTensor cache split over its batch and sequence dimensions, each
    rank writes the rows whose position falls in its own block of the
    sequence and rewrites the others' current values, with no
    communication (the reference's sharded in-place update): ``pos`` and
    ``value`` are first brought to the cache's batch split."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = value
        return
    mesh = cache.device_mesh
    rows_pl = [p if p.is_shard(0) else Replicate() for p in cache.placements]
    pos_l = _like(pos, mesh, rows_pl).to_local().long()
    value_l = _like(value, mesh, rows_pl).to_local()
    local = cache.to_local()
    _, offset = block(cache.shape, mesh, cache.placements)
    at = pos_l - offset[1]
    mine = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    mine = mine.reshape(-1, *([1] * (value_l.dim() - 1)))
    local[rows, at] = torch.where(mine, value_l.to(local.dtype), local[rows, at])


def empty_stack(n: int, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialized (n, *like.shape) tensor of ``dtype`` whose slices
    take ``like``'s layout: plain beside a plain tensor, a DTensor split as
    ``like`` is (a pending sum taken as replicated) beside a DTensor."""
    if not isinstance(like, DTensor):
        return torch.empty((n, *like.shape), dtype=dtype, device=like.device)
    local = like.to_local()
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
                  for p in like.placements]
    shape = torch.Size((n, *like.shape))
    return DTensor.from_local(
        torch.empty((n, *local.shape), dtype=dtype, device=local.device), like.device_mesh,
        placements, run_check=False, shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def row_split(table: torch.Tensor) -> bool:
    """Whether ``table`` is a DTensor whose rows are split over the mesh."""
    return isinstance(table, DTensor) and any(
        isinstance(p, Shard) and p.dim == 0 for p in table.placements)


def gather_rows(table: DTensor, ids: torch.Tensor) -> DTensor:
    """``table[ids]`` for a DTensor ``table`` whose rows are split (a
    vocabulary or an embedding table): each rank looks up the ids that fall
    in its own block of rows and gives zeros for the others, and the
    blocks' lookups are a pending sum over the row split, reduced where the
    result is next read (the vocabulary-parallel lookup).  ``ids`` (in
    range) keep their own split over the other mesh dimensions."""
    mesh = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    ids_pl = list(ids.placements) if isinstance(ids, DTensor) else [Replicate()] * mesh.ndim
    ids_pl = [Replicate() if r else p for p, r in zip(ids_pl, rows)]
    ids_l = _like(ids, mesh, ids_pl).to_local().long()
    local = table.redistribute(mesh, [Shard(0) if r else Replicate() for r in rows]).to_local()
    _, offset = block(table.shape, mesh, [Shard(0) if r else Replicate() for r in rows])
    at = ids_l - offset[0]
    mine = (at >= 0) & (at < local.shape[0])
    out = local[at.clamp(0, local.shape[0] - 1)]
    out = torch.where(mine[..., None], out, out.new_zeros(()))
    placements = [Partial() if r else p for p, r in zip(ids_pl, rows)]
    shape = torch.Size((*ids.shape, *table.shape[1:]))
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def map_rank_rows(fn, *tensors: torch.Tensor) -> DTensor:
    """``fn`` over this rank's rows of ``tensors`` (DTensors split over
    their first dimension alike, or plain tensors taken whole): each rank
    runs ``fn`` on its own rows (in the chunks ``fn`` makes), given as
    DTensors replicated over the mesh, whose values differ between ranks
    while the program does not, and the rows of the result come back split
    as the first tensor's are, gathered whole over the mesh on each rank
    first."""
    mesh = tensors[0].device_mesh
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in tensors[0].placements]
    rep = [Replicate()] * mesh.ndim
    out = fn(*(DTensor.from_local(t.redistribute(mesh, rows).to_local(), mesh, rep,
                                  run_check=False) if isinstance(t, DTensor) else t
               for t in tensors))
    if isinstance(out, DTensor):
        out = out.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    shape = torch.Size((tensors[0].shape[0], *out.shape[1:]))
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def index_add_rows(data: torch.Tensor, ids: torch.Tensor, n: int) -> DTensor:
    """``zeros((n, ...)).index_add(0, ids, data)`` for a DTensor ``data``
    whose rows (edges) are split over some mesh dimensions: each rank adds
    its own rows into a whole (n, ...) buffer, and the buffers are a pending
    sum over those dimensions, reduced where the result is next read (the
    edge-parallel scatter of message passing).  ``ids`` is brought to the
    rows' split first; ``data``'s other dimensions are gathered."""
    mesh = data.device_mesh
    rows_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in data.placements]
    data_l = data.redistribute(mesh, rows_pl).to_local()
    ids_l = _like(ids, mesh, rows_pl).to_local()
    out = torch.zeros((n, *data_l.shape[1:]), dtype=data_l.dtype, device=data_l.device)
    out = out.index_add(0, ids_l, data_l)
    shape = torch.Size((n, *data.shape[1:]))
    return DTensor.from_local(
        out, mesh, [Partial() if isinstance(p, Shard) else p for p in rows_pl],
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


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
