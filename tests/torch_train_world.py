"""A gloo world of 4 ranks on the CPU running the port's two-level
data-parallel step, for ``tests/test_torch_train_loop.py``.

    python tests/torch_train_world.py IN.npz OUT.npz

spawns 4 ranks (``torch.multiprocessing``, spawn) that join one gloo group,
split it into 2 pods of 2 data ranks (``launch.mesh.dp_groups``) and train
the linear problem of IN (``x``, ``y``, ``steps``) with SGD (lr 0.15, no
clipping), each rank on its quarter of the rows, with the pod hop
compressed and uncompressed.  Rank 0 writes the parameters, losses and its
and rank 2's residuals (pods 0 and 1) to OUT, with ``replicated`` true when
every rank's parameters equal its own, and ``single_w``, the same steps in
one process on the whole batch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD, PODS = 4, 2


def _loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}


def _run(rank: int, port: int, inp: str, outp: str) -> None:
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop

    grp = mesh.init_group(rank, WORLD, "gloo", port, timeout_s=120)
    groups = mesh.dp_groups(PODS)
    data = np.load(inp)
    batch = {"x": torch.from_numpy(data["x"]), "y": torch.from_numpy(data["y"])}
    steps = int(data["steps"])
    ocfg = opt_lib.OptConfig(name="sgd", lr=0.15, grad_clip=0.0)
    out, replicated = {}, True
    for compress in (True, False):
        p = {"w": torch.zeros(16, 4)}
        opt = opt_lib.init_opt_state(p, ocfg)
        err = train_loop.init_pod_error_state(p)
        step = train_loop.make_sharded_train_step(_loss, ocfg, groups, compress_pod=compress)
        for _ in range(steps):
            p, opt, err, m = step(p, opt, err, groups.local_rows(batch))
        tag = "comp" if compress else "full"
        everyone = [None] * WORLD
        torch.distributed.all_gather_object(everyone, (p["w"].numpy(), err["w"].numpy()),
                                            group=grp)
        replicated &= all(np.array_equal(w, everyone[0][0]) for w, _ in everyone)
        out[tag + "_w"], out[tag + "_loss"] = p["w"].numpy(), np.float32(m["loss"])
        out[tag + "_err0"], out[tag + "_err2"] = everyone[0][1], everyone[2][1]
    if rank == 0:
        p = {"w": torch.zeros(16, 4)}
        opt = opt_lib.init_opt_state(p, ocfg)
        step = train_loop.make_train_step(_loss, ocfg)
        for _ in range(steps):
            p, opt, _ = step(p, opt, batch)
        out["single_w"], out["replicated"] = p["w"].numpy(), np.bool_(replicated)
        np.savez(outp, **out)
    mesh.close_group()


def main(argv) -> None:
    from repro_torch.launch.mesh import free_port

    mp.spawn(_run, args=(free_port(), argv[1], argv[2]), nprocs=WORLD, join=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    main(sys.argv)
