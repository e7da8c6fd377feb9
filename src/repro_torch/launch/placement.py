"""Plan the placement of every arch on the production meshes, with no card
and nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.placement [--json PATH]

For each arch of the registry (the five LMs, MACE and the four recommender
models) at its ``full_config()``, the parameters and the optimizer state
are made under ``FakeTensorMode`` (shapes and dtypes only) and placed by
their specs (``param_pspecs`` and ``optimizer.opt_state_pspecs``) on the
reference's (16, 16) and (2, 16, 16) meshes, each laid over a fake world of
256 or 512 ranks (``launch.mesh.fake_world``).  It prints rank 0's planned
bytes of parameters and optimizer state per arch and mesh: the largest
block of an uneven split, so the most any rank holds.  These are planned
bytes, read from the placed tensors' local shapes, not measurements.

The choices are the reference's dry run's: LMs take the FSDP specs
(``fsdp=True``) and AdamW, Adafactor past 10¹¹ parameters; MACE and the
recommenders take AdamW.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mace, recsys, sharding, transformer
from repro_torch.train import optimizer

ARCHS = tuple(configs.names(include_knn=False))
MESHES = {"16x16": False, "2x16x16": True}


def opt_config(arch: str, cfg) -> optimizer.OptConfig:
    """The optimizer the reference's dry run plans ``arch`` with."""
    if configs.get(arch).FAMILY == "lm" and cfg.param_count() > 1e11:
        return optimizer.OptConfig(name="adafactor")
    return optimizer.OptConfig(name="adamw")


def arch_tree(arch: str):
    """(params, param specs, optimizer config) of ``arch`` at its
    ``full_config()``; call under ``FakeTensorMode`` to allocate nothing."""
    mod = configs.get(arch)
    cfg = mod.full_config()
    if mod.FAMILY == "lm":
        params = {name: torch.empty(shape, dtype=dt)
                  for name, (shape, dt) in transformer.param_shapes(cfg).items()}
        specs = transformer.param_pspecs(cfg, fsdp=True)
    elif arch == "mace":
        params = mace.init_params(torch.Generator().manual_seed(0), cfg)
        specs = mace.param_pspecs(cfg)
    else:
        params = recsys.init_params(torch.Generator().manual_seed(0), cfg)
        specs = recsys.param_pspecs(cfg)
    return params, specs, opt_config(arch, cfg)


def place_arch(arch: str, mesh):
    """``arch``'s parameters and optimizer state, fake, placed on ``mesh``:
    (params, param specs, state, state specs), the trees as DTensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params, specs, ocfg = arch_tree(arch)
        state = optimizer.init_opt_state(params, ocfg)
        state_specs = optimizer.opt_state_pspecs(specs, params, ocfg)
        return (sharding.place(params, specs, mesh), specs,
                sharding.place(state, state_specs, mesh), state_specs)


def plan(multi_pod: bool, archs=ARCHS) -> dict:
    """{arch: {"params": bytes, "opt_state": bytes}} of rank 0 on one
    production mesh, planned in a fake world that is left afterwards."""
    shape, _ = mesh_lib.PRODUCTION_MESHES[multi_pod]
    world = 1
    for s in shape:
        world *= s
    mesh_lib.fake_world(world)
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        out = {}
        for arch in archs:
            params, _, state, _ = place_arch(arch, mesh)
            out[arch] = {"params": sharding.local_bytes(params),
                         "opt_state": sharding.local_bytes(state)}
        return out
    finally:
        mesh_lib.close_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    table = {name: plan(multi_pod) for name, multi_pod in MESHES.items()}
    print("planned bytes per rank (rank 0, the largest block), not measured")
    print(f"{'arch':<14} {'mesh':<8} {'params GiB':>11} {'opt state GiB':>14} {'total GiB':>10}")
    for name, rows in table.items():
        for arch, b in rows.items():
            total = b["params"] + b["opt_state"]
            print(f"{arch:<14} {name:<8} {b['params'] / 2**30:>11.4f} "
                  f"{b['opt_state'] / 2**30:>14.4f} {total / 2**30:>10.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(table, f, indent=1)
    return table


if __name__ == "__main__":
    main()
