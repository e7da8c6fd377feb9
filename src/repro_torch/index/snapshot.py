"""Versioned on-disk snapshots of a k-NN index: manifest JSON + npz payload
(counterpart of ``repro.index.snapshot``, in the same format, so a snapshot
written by either package loads in the other).

    <path>/manifest.json   format version, shapes, dtypes, build config
    <path>/payload.npz     the arrays, canonical dtypes (int32/float32/bool)

Restore policy:

  * every array is cast back to its canonical dtype (``_CANONICAL``);
  * the ``sq_norms``/``row_scale`` caches are stored verbatim by v3 writers
    and restored verbatim; v1/v2 payloads carry neither and re-derive both
    through ``graph.attach_sq_norms``;
  * the reverse side is checked against the structure ``rebuild_reverse``
    gives (``_reverse_ok``); a payload without it, or failing the check, is
    repaired by rebuilding it from the forward lists;
  * the optional coarse level (``coarse_*``) stores the landmark rows,
    routing points, member rings and the coarse graph's forward lists only;
    its reverse side and caches re-derive on load;
  * an optional ``pq_codebook`` keeps a PQ index in the code space it was
    built with;
  * a newer ``format_version`` is refused.

The build config round-trips as a dict through
``convert.build_config_from_dict``; fields it does not know (a later
writer's) are dropped, as the reference drops them.  Writes are staged in a sibling
directory and swapped in, so a crash cannot leave a torn snapshot.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core.construct import BuildConfig
from repro_torch.core.graph import KNNGraph
from repro_torch.core.hierarchy import CoarseLevel

FORMAT_VERSION = 3

MANIFEST_NAME = "manifest.json"
PAYLOAD_NAME = "payload.npz"

# canonical dtype of each persisted array; load casts back through it
_CANONICAL = {
    "nbr_ids": np.int32,
    "nbr_dist": np.float32,
    "nbr_lam": np.int32,
    "rev_ids": np.int32,
    "rev_lam": np.int32,
    "rev_ptr": np.int32,
    "alive": np.bool_,
    "items": np.float32,
    # v2: the coarse entry-point level
    "coarse_landmark_rows": np.int32,
    "coarse_points": np.float32,
    "coarse_members": np.int32,
    "coarse_mem_ptr": np.int32,
    "coarse_nbr_ids": np.int32,
    "coarse_nbr_dist": np.float32,
    "coarse_nbr_lam": np.int32,
    # v3: the PQ codebook and the cache tables, stored verbatim
    "pq_codebook": np.float32,
    "sq_norms": np.float32,
    "row_scale": np.float32,
}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(
    path: str,
    g: KNNGraph,
    items: torch.Tensor,
    cfg: BuildConfig,
    *,
    coarse: Optional[CoarseLevel] = None,
    pq_codebook: Optional[torch.Tensor] = None,
    extra_meta: Optional[dict] = None,
) -> str:
    """Write a versioned snapshot of (graph, data, config) under ``path``;
    ``items`` is the (capacity, d) data region backing the graph rows.  Data
    stored in another dtype (a ``data_bf16`` build's bfloat16) is written as
    float32, lossless for bf16, with its dtype recorded as ``items_dtype``
    and restored on load, as the reference does."""
    arrays = {
        "nbr_ids": g.nbr_ids,
        "nbr_dist": g.nbr_dist,
        "nbr_lam": g.nbr_lam,
        "rev_ids": g.rev_ids,
        "rev_lam": g.rev_lam,
        "rev_ptr": g.rev_ptr,
        "alive": g.alive,
        "items": items.float(),
        "sq_norms": g.sq_norms,
        "row_scale": g.row_scale,
    }
    if coarse is not None:
        arrays.update(
            coarse_landmark_rows=coarse.landmark_rows,
            coarse_points=coarse.points.float(),
            coarse_members=coarse.members,
            coarse_mem_ptr=coarse.mem_ptr,
            coarse_nbr_ids=coarse.graph.nbr_ids,
            coarse_nbr_dist=coarse.graph.nbr_dist,
            coarse_nbr_lam=coarse.graph.nbr_lam,
        )
    if pq_codebook is not None:
        arrays["pq_codebook"] = pq_codebook
    arrays = {k: _host(v).astype(_CANONICAL[k]) for k, v in arrays.items()}
    manifest = {
        "format_version": FORMAT_VERSION,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "torch_version": torch.__version__,
        "n_valid": int(g.n_valid),
        "capacity": int(g.capacity),
        "k": int(g.k),
        "rev_capacity": int(g.rev_capacity),
        "dim": int(items.shape[1]),
        "items_dtype": str(items.dtype).removeprefix("torch."),
        "build_config": dataclasses.asdict(cfg),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in arrays.items()},
    }
    if extra_meta:
        manifest["extra"] = extra_meta
    # stage payload and manifest beside the target, then swap them in
    stage = path.rstrip(os.sep) + ".tmp"
    if os.path.isdir(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    np.savez(os.path.join(stage, PAYLOAD_NAME), **arrays)
    with open(os.path.join(stage, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    old = None
    if os.path.isdir(path) and os.listdir(path):
        old = path.rstrip(os.sep) + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(path, old)
    elif os.path.isdir(path):
        os.rmdir(path)
    os.replace(stage, path)
    if old is not None:
        shutil.rmtree(old)
    return path


def _reverse_ok(g: KNNGraph) -> bool:
    """The reverse side's structure: ids in [-1, capacity), no dead owners,
    non-negative append counters (which count every append, so they may
    exceed the ring's capacity)."""
    ids = g.rev_ids
    in_range = bool(((ids >= -1) & (ids < g.capacity)).all())
    owners_alive = bool(((ids < 0) | g.alive[ids.clamp(0, g.capacity - 1).long()]).all())
    return in_range and owners_alive and bool((g.rev_ptr >= 0).all())


def load(
    path: str,
    *,
    validate_reverse: bool = True,
    with_coarse: bool = False,
    with_pq_codebook: bool = False,
    device=None,
):
    """Restore (graph, items, config, manifest) from a snapshot directory,
    plus the coarse level (or None) with ``with_coarse`` and then the PQ
    codebook (or None) with ``with_pq_codebook``.  ``device``: where the
    tensors go (None: the card, raising without one).

    Raises ``ValueError`` for a newer format, a payload missing the forward
    graph or data, or a manifest that disagrees with its payload."""
    dev = device_lib.resolve(device)
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    version = int(manifest.get("format_version", 0))
    if version > FORMAT_VERSION:
        raise ValueError(
            f"snapshot at {path!r} has format_version {version}; this reader "
            f"understands <= {FORMAT_VERSION}"
        )
    with np.load(os.path.join(path, PAYLOAD_NAME)) as z:
        raw = {k: z[k] for k in z.files}
    missing = [k for k in ("nbr_ids", "nbr_dist", "nbr_lam", "items") if k not in raw]
    if missing:
        raise ValueError(
            f"snapshot at {path!r} is missing payload arrays {missing}; the "
            "forward graph and data region are not reconstructible"
        )
    for name, spec in manifest.get("arrays", {}).items():
        if name in raw and list(raw[name].shape) != list(spec["shape"]):
            raise ValueError(
                f"snapshot at {path!r} is corrupt: payload array {name!r} has shape "
                f"{list(raw[name].shape)}, manifest records {spec['shape']}"
            )
    items_dtype = getattr(torch, manifest.get("items_dtype", "float32"), None)
    if not isinstance(items_dtype, torch.dtype) or not items_dtype.is_floating_point:
        raise ValueError(
            f"snapshot at {path!r} records items_dtype {manifest['items_dtype']!r}, "
            "not a float dtype"
        )

    def arr(name: str) -> Optional[torch.Tensor]:
        v = raw.get(name)
        return None if v is None else torch.from_numpy(np.asarray(v, _CANONICAL[name])).to(dev)

    nbr_ids = arr("nbr_ids")
    cap, k = nbr_ids.shape
    rev_cap = int(manifest.get("rev_capacity", 2 * k))
    n_valid = int(manifest["n_valid"])
    if not 0 <= n_valid <= cap:
        raise ValueError(
            f"snapshot at {path!r} is corrupt: n_valid {n_valid} outside [0, capacity={cap}]"
        )
    alive = arr("alive")
    if alive is None:  # payloads without liveness: every allocated row lives
        alive = torch.arange(cap, device=dev) < n_valid
    items = arr("items").to(items_dtype)
    empty = graph_lib.empty_graph(cap, k, rev_cap, device=dev)

    def or_empty(name):
        v = arr(name)
        return getattr(empty, name) if v is None else v

    g = KNNGraph(
        nbr_ids=nbr_ids,
        nbr_dist=arr("nbr_dist"),
        nbr_lam=arr("nbr_lam"),
        rev_ids=or_empty("rev_ids"),
        rev_lam=or_empty("rev_lam"),
        rev_ptr=or_empty("rev_ptr"),
        alive=alive,
        n_valid=n_valid,
        sq_norms=empty.sq_norms,
        row_scale=empty.row_scale,
    )
    if "sq_norms" in raw and "row_scale" in raw:
        g = g._replace(sq_norms=arr("sq_norms"), row_scale=arr("row_scale"))
    else:  # v1/v2: derive through the one definition of the caches
        g = graph_lib.attach_sq_norms(g, items)
    rev_missing = "rev_ids" not in raw or "rev_lam" not in raw
    if rev_missing or (validate_reverse and not _reverse_ok(g)):
        g = graph_lib.rebuild_reverse(g)

    # a later writer's fields, unknown to both packages, take their defaults
    cfg = convert.build_config_from_dict(
        {key: v for key, v in manifest.get("build_config", {}).items() if key in convert.CONFIG_KEYS}
    )
    out = [g, items, cfg, manifest]
    if with_coarse:
        coarse = None
        if "coarse_landmark_rows" in raw:
            points = arr("coarse_points")
            c_ids = arr("coarse_nbr_ids")
            L, kc = c_ids.shape
            gc = graph_lib.empty_graph(L, kc, 2 * kc, device=dev)._replace(
                nbr_ids=c_ids,
                nbr_dist=arr("coarse_nbr_dist"),
                nbr_lam=arr("coarse_nbr_lam"),
                alive=torch.ones(L, dtype=torch.bool, device=dev),
                n_valid=L,
            )
            gc = graph_lib.rebuild_reverse(graph_lib.attach_sq_norms(gc, points))
            coarse = CoarseLevel(
                landmark_rows=arr("coarse_landmark_rows"),
                points=points,
                graph=gc,
                members=arr("coarse_members"),
                mem_ptr=arr("coarse_mem_ptr"),
            )
        out.append(coarse)
    if with_pq_codebook:
        out.append(arr("pq_codebook"))
    return tuple(out)
