"""Checkpoints of named tensors, and wave-boundary checkpoints of a build
(counterpart of ``repro.train.checkpoint``, its save/restore half).

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other::

    <path>/manifest.json         step, process_count, leaves (name, file,
                                 shape, dtype) in sorted name order, meta
    <path>/shard-0/<name>.npy    one array per leaf

A tree here is a flat dict of name -> tensor (or int, written as an int32
scalar, as the reference's 0-d ``n_valid``).  ``save_graph`` writes a
``KNNGraph`` with the next row to insert as ``step`` and the build
configuration in ``meta``; ``restore_graph`` reads it back, and
``construct.build(initial=(graph, next_row))`` resumes the build there.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib

MANIFEST = "manifest.json"
_SHARD = "shard-0"


def _host(v) -> np.ndarray:
    """A tensor's array (bf16 widened to fp32, exactly: numpy has no
    bfloat16), or an int as an int32 scalar."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return np.asarray(v, np.int32)


def save(path: str, tree: dict, *, step: int = 0, meta: Optional[dict] = None) -> None:
    """Write ``tree`` (name -> tensor or int) under ``path``: one ``.npy``
    per leaf in ``shard-0`` and the manifest, leaves in sorted name order."""
    shard_dir = os.path.join(path, _SHARD)
    os.makedirs(shard_dir, exist_ok=True)
    records = []
    for name in sorted(tree):
        arr = _host(tree[name])
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(shard_dir, fn), arr)
        records.append({"name": name, "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest = {"step": int(step), "process_count": 1, "leaves": records, "meta": meta or {}}
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf's array as a tensor, bit for bit.  The reference writes a
    bfloat16 leaf (``ml_dtypes.bfloat16``) as 2-byte void under the
    manifest dtype ``"bfloat16"``; its bits are carried through int16 and
    viewed as ``torch.bfloat16``, as ``convert._from_numpy`` does."""
    if dtype == "bfloat16" and arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(path: str, like: dict, *, strict_shapes: bool = True, device=None) -> tuple[dict, int]:
    """Read the leaves named by ``like`` (name -> tensor or int) onto
    ``device`` (None: the card, raising without one), each in its ``like``
    leaf's dtype; an int leaf comes back as an int.  A bfloat16 leaf of the
    reference's restores bit for bit (``_tensor``).  Raises ``KeyError`` for
    a leaf the checkpoint lacks and, with ``strict_shapes``, ``ValueError``
    for a shape that differs.  Returns (tree, step)."""
    dev = device_lib.resolve(device)
    manifest = load_manifest(path)
    by_name = {r["name"]: r for r in manifest["leaves"]}
    out = {}
    for name, leaf in like.items():
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(path, _SHARD, by_name[name]["file"]))
        is_int = not isinstance(leaf, torch.Tensor)
        want = () if is_int else tuple(leaf.shape)
        if strict_shapes and tuple(arr.shape) != want:
            raise ValueError(f"leaf {name!r}: checkpoint shape {arr.shape} != target {want}")
        out[name] = int(arr) if is_int else _tensor(arr, by_name[name]["dtype"]).to(dev, leaf.dtype)
    return out, int(manifest["step"])


def save_graph(path: str, graph, next_row: int, build_cfg_dict: dict) -> None:
    """A wave-boundary checkpoint of a build: the graph's fields, ``step``
    the next row to insert, the build configuration in ``meta``."""
    save(path, graph._asdict(), step=next_row,
         meta={"kind": "knn_graph", "build_cfg": build_cfg_dict})


def restore_graph(path: str, like_graph, *, device=None):
    """(graph shaped like ``like_graph``, next row) from ``save_graph``'s
    checkpoint, on ``device`` (None: the card)."""
    tree, next_row = restore(path, like_graph._asdict(), device=device)
    return type(like_graph)(**tree), next_row
