"""Serving launcher: batched retrieval requests against an online index.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
        --n-items 8000 --d 16 --requests 20 --topk 10 \\
        [--snapshot PATH] [--trace PATH] [--device cpu]

Builds an ``OnlineIndex`` over unit-norm N(0,1) items under the inner
product, optionally round-trips it through a snapshot, and serves 4-query
requests through the instrumented ``ServingLoop``, reporting p50/p99
latency, QPS, recall and scanning rate.  Runs on the card unless
``--device cpu``.  ``--shards > 1`` (the sharded router) and ``--mode lm``
are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_retrieval(args) -> dict:
    from repro_torch.index import OnlineIndex
    from repro_torch.obs import JsonlTracker
    from repro_torch.serve import retrieval
    from repro_torch.serve.loop import ServeLoopConfig, ServingLoop

    dev = device_lib.resolve(args.device)
    tracker = None
    if args.trace:
        tracker = JsonlTracker(args.trace, run_meta={
            "launcher": "serve_retrieval", "mode": "retrieval", "n_items": args.n_items,
            "shards": args.shards, "device": str(dev),
        })
    gen = torch.Generator(device=dev).manual_seed(0)
    items = torch.randn((args.n_items, args.d), generator=gen, device=dev)
    items = items / torch.linalg.norm(items, dim=1, keepdim=True)
    _sync(dev)
    t0 = time.perf_counter()
    index = retrieval.build_index(items, k=16, metric="ip", wave=512,
                                  generator=torch.Generator(device=dev).manual_seed(1),
                                  device=dev)
    _sync(dev)
    print(f"indexed {args.n_items} items on {dev} in {time.perf_counter() - t0:.3f}s")
    if args.snapshot:
        t0 = time.perf_counter()
        index.save(args.snapshot)
        index = OnlineIndex.load(args.snapshot, device=dev)
        print(f"snapshot round trip ({args.snapshot}) in {time.perf_counter() - t0:.3f}s")

    loop = ServingLoop(index, ServeLoopConfig(top_k=args.topk, beam=48, max_batch=16),
                       tracker=tracker)
    qgen = torch.Generator(device=dev).manual_seed(100)
    for r in range(args.requests):
        loop.submit(torch.randn((4, args.d), generator=qgen, device=dev))
        loop.step()
        if r == 1:  # the first waves' one-time costs stay out of the window
            loop.reset_window()
    k = min(args.topk, 10)
    rec = loop.report(audit_k=k)
    print(f"{loop.served} queries in {rec['n_waves']} waves: "
          f"p50={rec['p50_latency_ms']:.3f}ms p99={rec['p99_latency_ms']:.3f}ms "
          f"qps={rec['qps']:.1f} recall@{k}={rec.get(f'recall_at_{k}', float('nan')):.3f} "
          f"scan_rate={rec['scanning_rate']:.4f}")
    if tracker is not None:
        tracker.finish()
        print(f"trace written to {args.trace}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["retrieval", "lm"], default="retrieval")
    ap.add_argument("--n-items", type=int, default=8000)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--shards", type=int, default=1,
                    help="serve through the sharded router (>1; not ported yet)")
    ap.add_argument("--snapshot", type=str, default=None, metavar="PATH",
                    help="save and restore the index through a snapshot before serving")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="write an obs.JsonlTracker trace (spans + metrics) of the run")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError(
            "--mode lm needs the model substrate, not ported yet (ROADMAP Queue A item 13)")
    if args.shards > 1:
        raise NotImplementedError(
            "--shards > 1 needs the sharded router, not ported yet (ROADMAP Queue A item 10)")
    return serve_retrieval(args)


if __name__ == "__main__":
    main()
