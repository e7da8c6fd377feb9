"""k-NN graph construction launcher: the online build end to end, then its
graph recall scored against brute force.

    PYTHONPATH=src python -m repro_torch.launch.build_graph \\
        --n 1000000 --d 128 --k 20 --wave 4096 --eval-sample 10000 \\
        [--kind {uniform,clustered,heavy_tailed,histogram}] \\
        [--precision {fp32,bf16,int8,pq}] [--algo olg] \\
        [--seed-mode coarse --coarse-landmarks L] \\
        [--ckpt DIR --ckpt-every 8 [--resume]] [--eval] \\
        [--parallel-shards 4 --refine-rounds 1 --search-chunk 4096]

The build is the knn-lgd configuration with the flags' fields replaced, over
``--kind`` rows (default ``clustered``) drawn from ``DATA_SEED``, with entry
points drawn from ``BUILD_SEED``; ``chip_smoke.py`` builds from the same
seeds, so the two agree at the same n, d and flags.

``--ckpt DIR`` checkpoints the graph every ``--ckpt-every`` waves and at the
end (``train.checkpoint.save_graph``, the reference's layout); ``--resume``
restarts from the last checkpoint in DIR.  A resumed random-seeded build
first advances the entry-point generator past the waves already committed,
so it ends with the graph of an uninterrupted build, bit for bit; under
``--seed-mode coarse`` it re-derives its coarse level from the resumed
graph, as the reference does.  ``--eval`` scores recall@1 and recall@k over
every row; ``--eval-sample M`` scores recall@10 over M strided rows.

``--parallel-shards S`` (S > 1) runs the divide-and-conquer build instead
(``construct.build_parallel``: S sub-builds, the merge tree,
``--refine-rounds`` NN-Descent rounds), keyed by ``TorchDraws(BUILD_SEED)``;
it takes no wave checkpoints (only the final graph goes to ``--ckpt``) and
refuses ``--resume``.  Runs on the card (the hand-written kernels);
``--device cpu`` runs the plain PyTorch versions instead.  Unlike the JAX
launcher, which pins ``dispatch="reference"``, nothing here selects an
engine: the device does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import knn_lgd
from repro_torch.core import brute, construct
from repro_torch.core import search as search_lib
from repro_torch.core.draws import TorchDraws
from repro_torch.core.graph import empty_graph
from repro_torch.data import synthetic
from repro_torch.kernels.precision import PRECISIONS
from repro_torch.train import checkpoint as ckpt_lib

DATA_SEED, BUILD_SEED = 7, 13


def make_data(n: int, d: int, metric: str, device, kind: str = "clustered") -> torch.Tensor:
    """The launcher's rows: ``kind`` from ``DATA_SEED`` (made non-negative
    for chi2)."""
    x = synthetic.make(kind, torch.Generator(device=device).manual_seed(DATA_SEED), n, d)
    return x.abs() if metric == "chi2" else x


def skip_waves(generator: torch.Generator, cfg, n: int, next_row: int) -> None:
    """Advance ``generator`` past the entry points that a from-scratch
    random-seeded build draws for its waves before ``next_row``: wave rows
    [pos, pos + W) draw (W, p) ids over the ``pos`` rows committed."""
    pos = min(cfg.n_seed_init, n)
    while pos < next_row:
        search_lib.random_seeds(cfg.wave, cfg.n_seeds, pos, generator, generator.device)
        pos += min(cfg.wave, n - pos)


def full_recall(x, g, k: int, metric: str) -> tuple[float, float]:
    """Graph recall@1 and recall@k over every row, self-match excluded."""
    n = x.shape[0]
    true_ids, _ = brute.brute_force_knn(
        x, x, k, metric, exclude_ids=torch.arange(n, dtype=torch.int32, device=x.device),
        sq_norms=g.sq_norms, device=x.device,
    )
    return (brute.recall_at_k(g.nbr_ids[:, :1], true_ids[:, :1], 1),
            brute.recall_at_k(g.nbr_ids, true_ids, k))


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
    ap.add_argument("--kind", default="clustered", choices=list(synthetic.GENERATORS))
    ap.add_argument("--algo", default="lgd", choices=["lgd", "olg"])
    ap.add_argument("--seed-mode", default="random", choices=["random", "coarse"],
                    help="entry points of the insertion searches: 'coarse' routes "
                         "through a landmark level (core.hierarchy)")
    ap.add_argument("--coarse-landmarks", type=int, default=None, metavar="L",
                    help="landmark count for --seed-mode coarse (default ~4·√n)")
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
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="checkpoint the graph here at wave boundaries and at the end")
    ap.add_argument("--ckpt-every", type=int, default=8, help="waves between checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume a sequential build from the checkpoint in --ckpt")
    ap.add_argument("--eval", action="store_true",
                    help="score recall@1 and recall@k over every row")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.parallel_shards > 1 and args.resume:
        raise SystemExit("--resume is a sequential-build feature "
                         "(parallel builds restart their sub-builds)")
    if args.resume and not args.ckpt:
        raise SystemExit("--resume needs --ckpt DIR, the checkpoint to resume from")

    dev = device_lib.resolve(args.device)
    x = make_data(args.n, args.d, args.metric, dev, args.kind)
    cfg = dataclasses.replace(
        knn_lgd.full_config(), k=args.k, metric=args.metric, wave=args.wave,
        lgd=args.algo == "lgd", beam=max(40, args.k), precision=args.precision,
        seed_mode=args.seed_mode, coarse_landmarks=args.coarse_landmarks,
    )
    cfg_dict = dataclasses.asdict(cfg)

    def checkpoint(n_waves, g):
        ckpt_lib.save_graph(args.ckpt, g, g.n_valid, cfg_dict)
        print(f"  wave {n_waves}: checkpointed at row {g.n_valid}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(BUILD_SEED)
    initial = None
    if args.resume and args.ckpt and os.path.exists(os.path.join(args.ckpt, ckpt_lib.MANIFEST)):
        like = empty_graph(args.n, args.k, cfg.rev_cap or 2 * args.k)
        g0, _ = ckpt_lib.restore_graph(args.ckpt, like, device=dev)
        initial = (g0, g0.n_valid)
        if cfg.seed_mode == "random":
            skip_waves(gen, cfg, args.n, g0.n_valid)
        print(f"resumed with {g0.n_valid} rows already committed", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.parallel_shards > 1:
        if args.ckpt:
            print("note: parallel builds take no wave checkpoints; only the final graph "
                  "goes to --ckpt")
        g, stats = construct.build_parallel(
            x, cfg, TorchDraws(BUILD_SEED), shards=args.parallel_shards,
            refine_rounds=args.refine_rounds, search_chunk=args.search_chunk, device=dev)
        mode = f" ({args.parallel_shards}-shard parallel)"
    else:
        g, stats = construct.build(
            x, cfg, generator=gen, device=dev, initial=initial,
            wave_callback=checkpoint if args.ckpt else None, callback_stride=args.ckpt_every)
        mode = ""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = construct.scanning_rate(stats, args.n)
    print(f"built {args.algo.upper()} graph on {dev}{mode}: n={args.n} d={args.d} "
          f"k={args.k} metric={args.metric} wave={args.wave} "
          f"precision={args.precision} in {dt:.3f}s "
          f"({(args.n / dt):.1f} rows/s), scanning rate c={c:.6f}")
    if args.ckpt:
        ckpt_lib.save_graph(args.ckpt, g, args.n, cfg_dict)
    if args.eval:
        r1, rk = full_recall(x, g, args.k, args.metric)
        print(f"graph recall@1={r1:.4f} recall@{args.k}={rk:.4f}")
    if args.eval_sample:
        r = graph_recall(x, g, min(10, args.k), args.metric, args.eval_sample)
        print(f"graph recall@{min(10, args.k)} over {args.eval_sample} rows = {r:.4f}")


if __name__ == "__main__":
    main()
