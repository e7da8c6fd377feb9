"""The reference's dry-run plans as JSON, for ``tests/test_torch_cells.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 python tests/torch_cells_reference.py OUT.json

Plans (``repro.configs.cells.plan``, nothing lowered) every cell of
``configs.all_cells(include_knn=True)`` on the 16x16 mesh, and gemma3-1b
``decode_32k``, mixtral-8x7b ``train_4k`` and knn-lgd ``search_4k`` on the
2x16x16 mesh, and writes for each: kind, skip reason, argument leaves (path,
shape, dtype), the specs of ``in_shardings``, ``model_flops``, ``notes``
and ``loop_factor``.  Needs the 512 host devices, so it runs in its own
process.
"""

from __future__ import annotations

import json
import sys

import jax
from jax.sharding import NamedSharding

from repro import configs
from repro.configs import cells
from repro.launch import mesh as mesh_lib

MULTI = (("gemma3-1b", "decode_32k"), ("mixtral-8x7b", "train_4k"), ("knn-lgd", "search_4k"))


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _path(p) -> list:
    return [_key(k) for k in p]


def record(arch, shape, mesh, skip):
    if skip:
        return {"arch": arch, "shape": shape, "skip": skip}
    cell = cells.plan(arch, shape, mesh)
    args = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    specs = jax.tree_util.tree_flatten_with_path(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {
        "arch": arch, "shape": shape, "skip": None, "kind": cell.kind,
        "args": [[_path(p), list(x.shape), str(x.dtype)] for p, x in args],
        "specs": [[_path(p), [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]]
                  for p, s in specs],
        "model_flops": cell.model_flops, "notes": cell.notes,
        "loop_factor": cell.loop_factor,
    }


def main(out_path: str) -> None:
    assert len(jax.devices()) == 512, "needs the 512 placeholder devices"
    single = mesh_lib.make_production_mesh(multi_pod=False)
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    out = {"single": [record(a, s, single, skip)
                      for a, s, skip in configs.all_cells(include_knn=True)],
           "multi": [record(a, s, multi, None) for a, s in MULTI]}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
