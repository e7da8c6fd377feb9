"""Quickstart on the PyTorch port: build a k-NN graph online (LGD), search
it, update it (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py                   # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --tiny

The paper's full loop, in the reference's order:
  1. online LGD construction over 5,000 clustered rows (d=32, k=10, Alg. 3)
     with the two-level coarse entry-point structure (a landmark sub-graph)
     built alongside; the coarse work is charged to ``n_comps``, so the
     scanning rate printed is honest; graph recall@10 against brute force;
  2. EHC search (Alg. 1) of 100 held-out queries, coarse-seeded and then
     random-seeded, with recall@1 against brute force and distance
     comparisons per query;
  3. dynamic updates (§IV-C): 500 rows inserted online with the coarse
     level carried, then 100 rows removed with λ repaired.

Rows come from seeded ``torch.Generator``s on the device; every entry
point comes from a ``core.draws.Draws`` (``run`` takes them injected, so a
caller can replay another stream of entry points).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import BuildConfig, SearchConfig, build, search
from repro_torch import device as device_lib
from repro_torch.core import brute, construct, dynamic
from repro_torch.core import draws as draws_lib
from repro_torch.core.graph import grow_graph
from repro_torch.data import synthetic

N, D, K, N_QUERIES, N_EXTRA, N_REMOVE = 5000, 32, 10, 100, 500, 100
# --tiny: the CPU test's size
TINY = dict(n=600, n_queries=20, n_extra=64, n_remove=16)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(x, q, extra, *, build_draws, search_draws, insert_draws, n_remove=N_REMOVE,
        device=None) -> dict:
    """The example's three stages on rows ``x`` (n, d), held-out queries
    ``q`` and insertion rows ``extra``, with the entry points of the build,
    both searches and the insert drawn from the given ``Draws``.  Returns
    what it printed and the graphs and results it made."""
    dev = device_lib.resolve(device)
    x, q, extra = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (x, q, extra))
    n, k = x.shape[0], K

    # -- 1. online construction with the coarse level -------------------------
    cfg = BuildConfig(k=k, metric="l2", wave=256, lgd=True, seed_mode="coarse")
    _sync(dev)
    t0 = time.perf_counter()
    g, stats, coarse = build(x, cfg, return_coarse=True, device=dev,
                             **draws_lib.build_kw(build_draws, n, cfg, dev))
    _sync(dev)
    build_s = time.perf_counter() - t0
    rate = construct.scanning_rate(stats, n)
    print(f"LGD graph built in {build_s:.3f}s on {dev} — scanning rate c={rate:.4f} "
          f"(brute force would be c=1.0); coarse level: {coarse.n_landmarks} landmarks")
    tids, _ = brute.brute_force_knn(x, x, k, "l2",
                                    exclude_ids=torch.arange(n, dtype=torch.int32, device=dev),
                                    device=dev)
    graph_recall = brute.recall_at_k(g.nbr_ids, tids, k)
    print(f"graph recall@{k} vs exact: {graph_recall:.4f}")

    # -- 2. k-NN search over the graph ----------------------------------------
    scfg = SearchConfig(k=k, beam=40, use_lgd_mask=True, seed_mode="coarse")
    B, p = q.shape[0], scfg.n_seeds
    seeds, coarse_seeds = draws_lib.search_entry(search_draws, B, p, g.n_valid,
                                                 coarse.n_landmarks, dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = search(g, x, q, scfg, seeds=seeds, coarse_seeds=coarse_seeds, coarse=coarse,
                 device=dev)
    _sync(dev)
    search_s = time.perf_counter() - t0
    tq, _ = brute.brute_force_knn(x, q, 1, "l2", device=dev)
    recall1 = brute.recall_at_k(res.ids[:, :1], tq, 1)
    comps = float(res.n_comps.float().mean())
    print(f"coarse-seeded search recall@1 = {recall1:.4f} at {comps:.1f} distance "
          f"comps/query (vs {n} brute) in {search_s * 1e3:.3f}ms for {B} queries")

    # the same search with random seeding, for the delta the coarse level buys
    rres = search(g, x, q, dataclasses.replace(scfg, seed_mode="random"),
                  seeds=draws_lib.search_entry(search_draws, B, p, g.n_valid, device=dev),
                  device=dev)
    rrecall1 = brute.recall_at_k(rres.ids[:, :1], tq, 1)
    rcomps = float(rres.n_comps.float().mean())
    print(f"random-seeded baseline:  recall@1 = {rrecall1:.4f} at {rcomps:.1f} comps/query")

    # -- 3. dynamic updates ----------------------------------------------------
    m = extra.shape[0]
    grown = grow_graph(g, n + m)  # carries every field, the ‖x‖² cache too
    x2 = torch.cat([x, extra])
    g2, _, coarse2 = dynamic.insert(
        grown, x2, m, cfg, coarse=coarse, device=dev,
        seed_fn=draws_lib.wave_seed_fn(insert_draws, cfg.n_seeds, coarse.n_landmarks, dev))
    print(f"inserted {m} new samples online -> n_valid={g2.n_valid} "
          f"(coarse members appended in the same waves)")
    g3 = dynamic.remove(g2, x2, torch.arange(n_remove, dtype=torch.int32, device=dev), "l2")
    alive = int(g3.alive.sum())
    print(f"removed {n_remove} samples (λ repaired, §IV-C) — alive rows: {alive}")
    return {"device": str(dev), "build_s": build_s, "scanning_rate": rate,
            "n_comps": int(stats.n_comps), "n_landmarks": coarse.n_landmarks,
            "graph_recall": graph_recall, "recall1": recall1, "comps_per_query": comps,
            "search_s": search_s, "random_recall1": rrecall1, "random_comps_per_query": rcomps,
            "n_valid": g2.n_valid, "alive": alive, "graph": g, "coarse": coarse, "result": res,
            "random_result": rres, "inserted": g2, "inserted_coarse": coarse2, "removed": g3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"), help="default: cuda")
    ap.add_argument("--tiny", action="store_true", help="the CPU test's size")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    size = TINY if args.tiny else dict(n=N, n_queries=N_QUERIES, n_extra=N_EXTRA,
                                       n_remove=N_REMOVE)
    n = size["n"]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # one draw split into the reference set and held-out queries (the
    # paper's protocol: queries share the data manifold)
    full = synthetic.clustered(gen(0), n + size["n_queries"], D)
    extra = synthetic.clustered(gen(9), size["n_extra"], D)
    out = run(full[:n], full[n:], extra, build_draws=draws_lib.TorchDraws(0),
              search_draws=draws_lib.TorchDraws(1), insert_draws=draws_lib.TorchDraws(2),
              n_remove=size["n_remove"], device=dev)
    assert out["n_valid"] == n + size["n_extra"]
    assert out["alive"] == n + size["n_extra"] - size["n_remove"]
    return out


if __name__ == "__main__":
    main()
