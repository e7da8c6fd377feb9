"""A gloo world of ranks on the CPU running the port's sharded paths, for
``tests/test_torch_distributed.py``.

    python tests/torch_distributed_world.py IN.npz OUT.npz [fail]

spawns 4 ranks (``torch.multiprocessing``, spawn) that join one gloo group
and run, on IN's integer rows ``x`` and queries ``q``, what the reference's
mesh runs in the test: the shard steps from per-shard exact seed graphs,
the scatter-gather search (and again with shard 0's rows dead), and
``build_parallel`` on the group: 4-way, 2-way on a sub-group of ranks 0-1
over the first half of the rows, and 4-way coarse-seeded.  Draws replay
the reference's keys (``torch_parity.JaxDraws``).  Rank 0 writes every
result to OUT, each rank's results having been checked equal to rank 0's.
With ``fail``, rank 2 raises before its first collective; the world must
then exit non-zero instead of hanging.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
CFG = dict(k=6, wave=32, n_seed_init=32, beam=12, n_seeds=4, hash_slots=256, max_iters=12)
COARSE = dict(seed_mode="coarse", coarse_landmarks=16, coarse_members=4)


def _graph_fields(g, prefix, out):
    from repro_torch import convert

    for name, v in convert.graph_to_numpy(g).items():
        out[prefix + name] = v


def _run(rank: int, port: int, inp: str, outp: str, fail: bool) -> None:
    sys.path[:0] = [HERE, os.path.join(HERE, "..", "src")]
    torch.set_num_threads(1)
    from repro_torch.launch import mesh

    grp = mesh.init_group(rank, WORLD, "gloo", port, timeout_s=120)
    if fail and rank == 2:
        raise RuntimeError("rank 2 fails before its first collective")
    if fail:  # the others wait in a collective that rank 2 never joins
        torch.distributed.barrier(group=grp)
    import jax

    import torch_parity as tp
    from repro_torch.core import construct, distributed

    data = np.load(inp)
    x, q = torch.from_numpy(data["x"]), torch.from_numpy(data["q"])
    n = x.shape[0]
    cfg = construct.BuildConfig(**CFG)
    out = {}

    # shard steps from per-shard exact seed graphs, lockstep waves
    g, xs = distributed.init_sharded_state(grp, x, cfg, device="cpu")
    out["init_ok"] = np.array(g.n_valid == cfg.n_seed_init)
    step = distributed.make_distributed_build_step(grp, cfg)
    draws = tp.JaxDraws(jax.random.PRNGKey(0))
    pos, comps, edges = g.n_valid, 0, 0
    while pos < xs.shape[0]:
        nr = min(cfg.wave, xs.shape[0] - pos)
        draws, sub = draws.split()
        g, c, e = step(g, xs, pos, nr, sub)
        comps, edges, pos = comps + c, edges + e, pos + nr
    shards = distributed.all_gather_graphs(g, grp)
    for name in ("nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam", "rev_ptr", "alive",
                 "sq_norms", "row_scale"):
        out["step_" + name] = torch.cat([getattr(s, name) for s in shards]).numpy()
    out["step_n_valid"] = np.int32(g.n_valid)
    out["step_comps"], out["step_edges"] = np.int64(comps), np.int64(edges)

    # scatter-gather search, then with shard 0's rows dead
    search = distributed.make_distributed_search(grp, cfg.search_config())
    ids, dd = search(g, xs, q, tp.JaxDraws(jax.random.PRNGKey(9)))
    out["search_ids"], out["search_d"] = ids.numpy(), dd.numpy()
    if rank == 0:
        g = g._replace(alive=torch.zeros_like(g.alive))
    ids, dd = search(g, xs, q, tp.JaxDraws(jax.random.PRNGKey(9)))
    out["blank_ids"], out["blank_d"] = ids.numpy(), dd.numpy()

    # build_parallel on the group: 4-way, 2-way on ranks 0-1, 4-way coarse
    gp, st = construct.build_parallel(x, cfg, tp.JaxDraws(jax.random.PRNGKey(1)), shards=WORLD,
                                      refine_rounds=1, mesh=grp, device="cpu")
    _graph_fields(gp, "par4_", out)
    out["par4_comps"] = np.int64(int(st.n_comps))
    pair = torch.distributed.new_group([0, 1])
    if rank < 2:
        gp, st = construct.build_parallel(x[: n // 2], cfg, tp.JaxDraws(jax.random.PRNGKey(2)),
                                          shards=2, refine_rounds=1, mesh=pair, device="cpu")
        _graph_fields(gp, "par2_", out)
        out["par2_comps"] = np.int64(int(st.n_comps))
    cfg_c = dataclasses.replace(cfg, **COARSE)
    gp, st, lvl = construct.build_parallel(x, cfg_c, tp.JaxDraws(jax.random.PRNGKey(3)),
                                           shards=WORLD, refine_rounds=1, mesh=grp,
                                           return_coarse=True, device="cpu")
    _graph_fields(gp, "parc_", out)
    out["parc_comps"] = np.int64(int(st.n_comps))
    out["parc_landmarks"] = lvl.landmark_rows.numpy()

    # what the reference replicates must be equal on every rank
    replicated = sorted(k for k in out if k.startswith(("search_", "blank_", "par4_", "parc_"))
                        or (rank < 2 and k.startswith("par2_")))
    mine = {k: out[k] for k in replicated}
    everyone = [None] * WORLD
    torch.distributed.all_gather_object(everyone, mine, group=grp)
    if rank == 0:
        for r, theirs in enumerate(everyone):
            for k in replicated if r < 2 else [k for k in replicated if not k.startswith("par2_")]:
                if not np.array_equal(theirs[k], out[k]):
                    raise AssertionError(f"rank {r} differs from rank 0 in {k}")
        np.savez(outp, **out)
    mesh.close_group()


def main(argv) -> None:
    from repro_torch.launch.mesh import free_port

    inp, outp = argv[1], argv[2]
    fail = argv[3:] == ["fail"]
    mp.spawn(_run, args=(free_port(), inp, outp, fail), nprocs=WORLD, join=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    main(sys.argv)
