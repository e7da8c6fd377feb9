"""Divide-and-conquer construction on the PyTorch port: partition -> build
-> merge -> refine -> serve (the counterpart of ``examples/parallel_build.py``).

    PYTHONPATH=src python examples/parallel_build_torch.py                  # on the card
    PYTHONPATH=src python examples/parallel_build_torch.py --device cpu --tiny

The paper builds its k-NN graph by sequential online insertion, which caps
construction throughput at one wave pipeline.  The divide-and-conquer path
partitions the dataset, builds an independent sub-graph per partition
through the same wave pipeline, folds the sub-graphs together with
``merge.symmetric_merge`` (each side's rows search the other side's graph;
joint top-k per row; reverse lists rebuilt canonically), and closes the
residual recall gap with a bounded NN-Descent sweep (``nndescent.refine``).
On 6,000 Gaussian rows, d=16, k=16 and 4 shards it runs the sequential
build, ``build_parallel``, the same phases spelled out, then a sharded
router collapsed onto one index with ``ShardedIndex.merge_shards``: its
exact answers must not change (asserted), and the merged index keeps
taking inserts and removals.

Rows come from seeded ``torch.Generator``s; every entry point from a
``core.draws.Draws`` (``run`` takes them injected, so a caller can replay
another stream).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import BuildConfig, ShardedIndex, build, build_parallel
from repro_torch import device as device_lib
from repro_torch.core import brute, construct, merge, nndescent
from repro_torch.core import draws as draws_lib

N, D, K, SHARDS, N_QUERIES, N_ADD = 6000, 16, 16, 4, 4, 8
# --tiny: the CPU test's size
TINY = dict(n=512)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def graph_recall(g, x, k: int = 10) -> float:
    true_ids, _ = brute.brute_force_knn(
        x, x, k, "l2", exclude_ids=torch.arange(x.shape[0], dtype=torch.int32, device=x.device),
        device=x.device)
    return brute.recall_at_k(g.nbr_ids[:, :k], true_ids, k)


def run(x, q, new_rows, *, draws, add_seed_fn=None, device=None) -> dict:
    """The example's stages on rows ``x`` (n, d) with router queries ``q``
    and post-merge inserts ``new_rows``.  ``draws`` maps each stage to its
    ``Draws``: "build" (the sequential and the parallel build), "half_a",
    "half_b", "merge" (the spelled-out phases), "router", "collapse" and
    "serve".  ``add_seed_fn`` keys the post-merge insert (None: the index's
    own default).  Returns what it printed and the graphs and ids it made."""
    dev = device_lib.resolve(device)
    x, q, new_rows = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (x, q, new_rows))
    n = x.shape[0]
    cfg = BuildConfig(k=K, metric="l2", wave=256)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    # -- 1. sequential baseline: one wave pipeline ----------------------------
    (g_seq, _), t_seq = timed(lambda: build(x, cfg, device=dev,
                                            **draws_lib.build_kw(draws["build"], n, cfg, dev)))
    r_seq = graph_recall(g_seq, x)
    print(f"sequential build on {dev}: {t_seq:.3f}s  recall@10={r_seq:.4f}")

    # -- 2. partition + sub-builds + merge + refine, in one call --------------
    (g_par, stats), t_par = timed(lambda: build_parallel(
        x, cfg, draws["build"], shards=SHARDS, refine_rounds=1, device=dev))
    r_par = graph_recall(g_par, x)
    rate = construct.scanning_rate(stats, n)
    print(f"{SHARDS}-shard parallel build: {t_par:.3f}s  recall@10={r_par:.4f}  "
          f"scanning rate c={rate:.4f}")

    # -- 3. the same phases, spelled out --------------------------------------
    bounds = construct.partition_bounds(n, 2)
    b = int(bounds[1])
    ga, _ = build(x[:b], cfg, device=dev, **draws_lib.build_kw(draws["half_a"], b, cfg, dev))
    gb, _ = build(x[b:], cfg, device=dev,
                  **draws_lib.build_kw(draws["half_b"], n - b, cfg, dev))
    g_merged, _ = merge.symmetric_merge(ga, gb, x, cfg.search_config(), draws["merge"])
    r_merged = graph_recall(g_merged, x)
    print(f"pairwise merge only:   recall@10={r_merged:.4f}")
    g_refined, _ = nndescent.refine(g_merged, x, cfg.metric, rounds=1)
    r_refined = graph_recall(g_refined, x)
    print(f"after 1 refine round:  recall@10={r_refined:.4f}")

    # -- 4. serving-side collapse: a sharded router becomes one index ---------
    router = ShardedIndex.build(x, SHARDS, cfg, draws=draws["router"], device=dev)
    B = q.shape[0]
    exact_fan = [router.retrieve(q[i:i + 1], 10, brute=True)[0] for i in range(B)]
    router.merge_shards(refine_rounds=1, draws=draws["collapse"])
    hits, served = 0, []
    for i in range(B):
        exact_one, _ = router.retrieve(q[i:i + 1], 10, brute=True)
        assert np.array_equal(exact_fan[i], exact_one)  # same catalog, same ids
        ids_g, _ = router.retrieve(q[i:i + 1], 10, beam=64, draws=draws["serve"])
        served.append(ids_g)
        hits += len(set(ids_g.tolist()) & set(exact_one.tolist()))
    print(f"router collapse: {SHARDS} shards -> {router.n_shards}, exact results identical, "
          f"graph serving recall {hits}/{10 * B} (global ids preserved)")

    # the merged index stays online: churn keeps working
    gids = router.add(new_rows, seed_fn=add_seed_fn)
    router.remove(gids[: new_rows.shape[0] // 2])
    print(f"post-merge churn ok: n_items={router.n_items}")
    return {"device": str(dev), "t_seq": t_seq, "recall_sequential": r_seq, "t_par": t_par,
            "recall_parallel": r_par, "scanning_rate": rate, "n_comps": int(stats.n_comps),
            "recall_merged": r_merged, "recall_refined": r_refined, "hits": hits,
            "n_shards": router.n_shards, "n_items": router.n_items, "gids": gids,
            "sequential": g_seq, "parallel": g_par, "merged": g_merged, "refined": g_refined,
            "exact": exact_fan, "served": served, "router": router}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"), help="default: cuda")
    ap.add_argument("--tiny", action="store_true", help="the CPU test's size")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    n = TINY["n"] if args.tiny else N

    def normal(seed, rows):
        return torch.randn((rows, D), generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    stages = ("build", "half_a", "half_b", "merge", "router", "serve", "collapse")
    out = run(normal(0, n), normal(6, N_QUERIES), normal(9, N_ADD), device=dev,
              draws={name: draws_lib.TorchDraws(seed) for seed, name in enumerate(stages, 1)})
    assert out["n_shards"] == 1 and out["n_items"] == n + N_ADD - N_ADD // 2
    return out


if __name__ == "__main__":
    main()
