"""k-NN graph construction launcher: the online build end to end, then its
graph recall scored against brute force.

    PYTHONPATH=src python -m repro_torch.launch.build_graph \\
        --n 1000000 --d 128 --k 20 --wave 4096 --eval-sample 10000 \\
        [--precision {fp32,bf16,int8,pq}] \\
        [--parallel-shards 4 --refine-rounds 1 --search-chunk 4096]

The build is the knn-lgd configuration with the flags' fields replaced, over
``clustered`` rows drawn from ``DATA_SEED``, with entry points drawn from
``BUILD_SEED``; ``chip_smoke.py`` builds from the same seeds, so the two
agree at the same n, d and flags.  ``--parallel-shards S`` (S > 1) runs the
divide-and-conquer build instead (``construct.build_parallel``: S sub-builds,
the merge tree, ``--refine-rounds`` NN-Descent rounds), keyed by
``TorchDraws(BUILD_SEED)``.  Runs on the card (the hand-written
kernels); ``--device cpu`` runs the plain PyTorch versions instead.  Unlike
the JAX launcher, which pins ``dispatch="reference"``, nothing here selects
an engine: the device does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import knn_lgd
from repro_torch.core import brute, construct
from repro_torch.core.draws import TorchDraws
from repro_torch.data import synthetic
from repro_torch.kernels.precision import PRECISIONS

DATA_SEED, BUILD_SEED = 7, 13


def make_data(n: int, d: int, metric: str, device) -> torch.Tensor:
    """The launcher's rows: ``clustered`` from ``DATA_SEED`` (made
    non-negative for chi2)."""
    x = synthetic.clustered(torch.Generator(device=device).manual_seed(DATA_SEED), n, d)
    return x.abs() if metric == "chi2" else x


def graph_recall(x, g, k: int, metric: str, sample: int) -> float:
    """Graph recall@k over ``sample`` strided rows, self-match excluded."""
    n = x.shape[0]
    rows = torch.arange(0, n, max(1, n // sample), device=x.device)[:sample]
    true_ids, _ = brute.brute_force_knn(
        x, x[rows], k, metric, exclude_ids=rows.to(torch.int32),
        sq_norms=g.sq_norms, device=x.device,
    )
    return brute.recall_at_k(g.nbr_ids[rows.long()], true_ids, k)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--metric", default="l2", choices=["l2", "ip", "cosine", "l1", "chi2"])
    ap.add_argument("--algo", default="lgd", choices=["lgd", "olg"])
    ap.add_argument("--wave", type=int, default=512)
    ap.add_argument("--precision", default="fp32", choices=list(PRECISIONS),
                    help="distance engine of the insertion searches: compressed "
                         "tables (bf16/int8) or PQ rank-then-rerank")
    ap.add_argument("--eval-sample", type=int, default=0, metavar="M",
                    help="score graph recall@10 over M strided rows (0: skip)")
    ap.add_argument("--parallel-shards", type=int, default=1, metavar="S",
                    help="divide-and-conquer build: S sub-graphs folded by symmetric "
                         "merges (1: the sequential online build)")
    ap.add_argument("--refine-rounds", type=int, default=1,
                    help="NN-Descent rounds after the merge (parallel builds)")
    ap.add_argument("--search-chunk", type=int, default=512,
                    help="cross-search batch of the merge (parallel builds)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a checkpointed sequential build (not ported yet)")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.resume:
        if args.parallel_shards > 1:
            raise SystemExit("--resume is a sequential-build feature "
                             "(parallel builds restart their sub-builds)")
        raise NotImplementedError(
            "--resume needs the graph checkpoints, not ported yet (ROADMAP Queue A item 10b)")

    dev = device_lib.resolve(args.device)
    x = make_data(args.n, args.d, args.metric, dev)
    cfg = dataclasses.replace(
        knn_lgd.full_config(), k=args.k, metric=args.metric, wave=args.wave,
        lgd=args.algo == "lgd", beam=max(40, args.k), precision=args.precision,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.parallel_shards > 1:
        g, stats = construct.build_parallel(
            x, cfg, TorchDraws(BUILD_SEED), shards=args.parallel_shards,
            refine_rounds=args.refine_rounds, search_chunk=args.search_chunk, device=dev)
        mode = f" ({args.parallel_shards}-shard parallel)"
    else:
        gen = torch.Generator(device=dev).manual_seed(BUILD_SEED)
        g, stats = construct.build(x, cfg, generator=gen, device=dev)
        mode = ""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = construct.scanning_rate(stats, args.n)
    print(f"built {args.algo.upper()} graph on {dev}{mode}: n={args.n} d={args.d} "
          f"k={args.k} metric={args.metric} wave={args.wave} "
          f"precision={args.precision} in {dt:.3f}s "
          f"({(args.n / dt):.1f} rows/s), scanning rate c={c:.6f}")
    if args.eval_sample:
        r = graph_recall(x, g, min(10, args.k), args.metric, args.eval_sample)
        print(f"graph recall@{min(10, args.k)} over {args.eval_sample} rows = {r:.4f}")


if __name__ == "__main__":
    main()
