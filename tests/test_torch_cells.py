"""The port's dry-run plans (``repro_torch.configs.cells.plan``) against the
reference's, cell by cell.

The reference plans in a child process with 512 host devices
(``tests/torch_cells_reference.py``; ``XLA_FLAGS`` is set in the child
only): every cell of ``configs.all_cells(include_knn=True)`` on the 16x16
mesh, and gemma3-1b ``decode_32k``, mixtral-8x7b ``train_4k`` and knn-lgd
``search_4k`` on the 2x16x16 mesh.  The port plans the same cells on the
same meshes over fake worlds of 256 and 512 ranks and must give, for every
cell, the same kind and skip reason, the same argument leaves (path, shape,
dtype) and specs leaf by leaf, ``model_flops`` to 1e-12 relative, and the
same ``notes`` and ``loop_factor``.  Nothing is traced here: the dry run
itself is ``tests/test_torch_dryrun.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import cells
from repro_torch.launch import dryrun

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
MULTI = (("gemma3-1b", "decode_32k"), ("mixtral-8x7b", "train_4k"), ("knn-lgd", "search_4k"))
SRC = HERE.parent / "src"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A function returning the reference's records; the child starts at
    once and runs while the port plans."""
    out = tmp_path_factory.mktemp("cells") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, str(HERE / "torch_cells_reference.py"), str(out)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.read_text())

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _dtype(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


def _spec(spec) -> list:
    """A spec as a list; an entry of one axis as its name (JAX's
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``; both split the
    dimension over that axis)."""
    out = []
    for e in spec:
        e = list(e) if isinstance(e, (tuple, list)) else e
        out.append(e[0] if isinstance(e, list) and len(e) == 1 else e)
    return out


def port_record(arch, shape, mesh, skip) -> dict:
    if skip:
        return {"arch": arch, "shape": shape, "skip": skip}
    cell = cells.plan(arch, shape, mesh)
    args, specs = [], []
    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings, strict=True)):
        args += [[[i, *p], list(x.shape), _dtype(x.dtype)] for p, x in cells.leaves(a)]
        specs += [[[i, *p], _spec(x)] for p, x in cells.spec_leaves(s)]
    return {"arch": arch, "shape": shape, "skip": None, "kind": cell.kind, "args": args,
            "specs": specs, "model_flops": cell.model_flops, "notes": cell.notes,
            "loop_factor": cell.loop_factor}


def _compare(got: dict, want: dict) -> None:
    where = f"{want['arch']} x {want['shape']}"
    assert got["skip"] == want["skip"], where
    if want["skip"]:
        return
    for key in ("kind", "notes", "loop_factor"):
        assert got[key] == want[key], (where, key)
    assert got["args"] == want["args"], where
    assert got["specs"] == [[p, _spec(x)] for p, x in want["specs"]], where
    if want["model_flops"] is None:
        assert got["model_flops"] is None, where
    else:
        assert got["model_flops"] == pytest.approx(want["model_flops"], rel=1e-12), where


def test_every_cell_plans_as_the_reference_on_both_meshes(reference):
    """Every cell on the 16x16 mesh (the three long_500k skips included),
    three cells on the 2x16x16 mesh."""
    todo = configs.all_cells(include_knn=True)
    with dryrun.production_mesh(multi_pod=False) as mesh:
        single = [port_record(arch, shape, mesh, skip) for arch, shape, skip in todo]
    with dryrun.production_mesh(multi_pod=True) as mesh:
        multi = [port_record(arch, shape, mesh, None) for arch, shape in MULTI]
    want = reference()
    assert [(r["arch"], r["shape"]) for r in single] == [
        (r["arch"], r["shape"]) for r in want["single"]]
    assert [(r["arch"], r["shape"]) for r in want["multi"]] == list(MULTI)
    assert sum(r["skip"] is not None for r in want["single"]) == 3
    for got, ref in zip(single + multi, want["single"] + want["multi"]):
        _compare(got, ref)
