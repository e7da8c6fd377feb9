"""Serving launcher: batched retrieval requests against an online index,
or token generation from an LM.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
        --n-items 8000 --d 16 --requests 20 --topk 10 \\
        [--shards 4] [--snapshot PATH] [--trace PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch gemma3-1b [--batch 4 --prompt-len 32 --gen 16] [--device cpu]

Builds an ``OnlineIndex`` over unit-norm N(0,1) items under the inner
product, optionally round-trips it through a snapshot, and serves 4-query
requests through the instrumented ``ServingLoop``, reporting p50/p99
latency, QPS, recall and scanning rate.  ``--shards S`` (S > 1) builds a
``ShardedIndex`` of S shards instead and serves each request through its
fan-out (``ShardedIndex.retrieve``, one ``router/shard<s>`` span per shard
in the trace), reporting p50/p99 latency and QPS.

``--mode lm`` serves an LM arch's smoke config (parameters from a seeded
generator): ``prefill`` of a random prompt, the cache padded by ``--gen``
positions, then greedy ``decode_step``s, printing tokens/s and a sample.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_sharded(args, items, dev, tracker) -> dict:
    """The router path: build, optional snapshot round trip, then one
    ``retrieve`` per 4-query request, latency taken around the merged
    answer (a host array, so the card's work is in it)."""
    import numpy as np

    from repro_torch.core.draws import TorchDraws
    from repro_torch.index import ShardedIndex

    t0 = time.perf_counter()
    index = ShardedIndex.build(items, args.shards, k=16, metric="ip", wave=512,
                               draws=TorchDraws(1), device=dev)
    _sync(dev)
    print(f"indexed {args.n_items} items over {args.shards} shards on {dev} in "
          f"{time.perf_counter() - t0:.3f}s")
    if args.snapshot:
        t0 = time.perf_counter()
        index.save(args.snapshot)
        index = ShardedIndex.load(args.snapshot, device=dev)
        print(f"snapshot round trip ({args.snapshot}) in {time.perf_counter() - t0:.3f}s")
    if tracker is not None:
        index.tracker = tracker
        for sh in index.shards:
            sh.tracker = tracker
    qgen = torch.Generator(device=dev).manual_seed(100)
    lat = []
    for r in range(args.requests):
        q = torch.randn((4, args.d), generator=qgen, device=dev)
        t0 = time.perf_counter()
        index.retrieve(q, args.topk, beam=48)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat[2:] if len(lat) > 2 else lat) * 1e3  # warm-up dropped
    rec = {"n_served": 4 * args.requests, "p50_latency_ms": float(np.percentile(lat_ms, 50)),
           "p99_latency_ms": float(np.percentile(lat_ms, 99)),
           "qps": 4 * lat_ms.size / (lat_ms.sum() / 1e3)}
    print(f"{args.requests} requests over {args.shards} shards: p50={rec['p50_latency_ms']:.3f}ms "
          f"p99={rec['p99_latency_ms']:.3f}ms qps={rec['qps']:.1f}")
    return rec


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
    if args.shards > 1:
        rec = serve_sharded(args, items, dev, tracker)
        if tracker is not None:
            tracker.finish()
            print(f"trace written to {args.trace}")
        return rec
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


def serve_lm(args) -> dict:
    """Prefill a (batch, prompt_len) random prompt, then decode ``--gen``
    tokens greedily (the first from the prefill's logits)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    dev = device_lib.resolve(args.device)
    cfg = configs.get(args.arch).smoke_config()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = tfm.prefill(params, prompt, cfg)
        # grow the cache for generation
        pad = (0, 0, 0, 0, 0, args.gen)
        cache = {"k": torch.nn.functional.pad(cache["k"], pad),
                 "v": torch.nn.functional.pad(cache["v"], pad), "len": cache["len"]}
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for _ in range(args.gen - 1):
            logits, cache = tfm.decode_step(params, cache, tok, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
        sample = torch.stack(out, 1)[0][:8].tolist()  # to the host: the work is done
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    print(f"{args.arch} on {dev}: prefill {args.prompt_len} + decode {args.gen} tokens x "
          f"{args.batch} in {dt:.2f}s ({total / dt:.0f} tok/s); sample: {sample}")
    return {"tokens": torch.stack(out, 1), "seconds": dt, "tok_s": total / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["retrieval", "lm"], default="retrieval")
    ap.add_argument("--arch", default="gemma3-1b", help="the LM of --mode lm")
    ap.add_argument("--n-items", type=int, default=8000)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--shards", type=int, default=1,
                    help="serve through the sharded router over this many shards (> 1)")
    ap.add_argument("--snapshot", type=str, default=None, metavar="PATH",
                    help="save and restore the index through a snapshot before serving")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="write an obs.JsonlTracker trace (spans + metrics) of the run")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args)
    return serve_retrieval(args)


if __name__ == "__main__":
    main()
