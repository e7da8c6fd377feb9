"""Index lifecycle end to end on the PyTorch port: build -> snapshot ->
restore -> churn -> compact (the counterpart of ``examples/lifecycle.py``).

    PYTHONPATH=src python examples/lifecycle_torch.py                   # on the card
    PYTHONPATH=src python examples/lifecycle_torch.py --device cpu --tiny

The paper's index is online — samples join and leave without a rebuild —
and the lifecycle layer (``repro_torch.index``) makes it long-lived too: the
graph survives the process through versioned snapshots, removed rows are
recycled instead of leaking capacity, and small inserts coalesce into one
wave.  This walks a serving replica through its whole life at fixed
capacity on 4,000 Gaussian rows, d=16, k=16, and asserts as it goes: the
restored replica serves bit-identical ids, churn never grows the capacity,
and the single-row adds fire exactly one insertion wave at the threshold.

Rows come from seeded ``torch.Generator``s; every entry point from a
``core.draws.Draws`` and every churn victim from ``pick`` (``run`` takes
them injected, so a caller can replay another stream).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import BuildConfig, OnlineIndex
from repro_torch import device as device_lib
from repro_torch.core import brute
from repro_torch.core import draws as draws_lib
from repro_torch.serve import retrieval

N, D, K, N_QUERIES, CHURN_ROUNDS, CHURN = 4000, 16, 16, 32, 4, 128
# --tiny: the CPU test's size
TINY = dict(n=512, churn=32)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def searcher(idx: OnlineIndex, draws):
    """A search-shaped ``seed_fn`` for ``idx`` drawing from ``draws``, the
    same entry points on every call (as the reference's fixed key)."""
    p = idx.build_cfg.n_seeds
    return lambda B, n_valid: draws_lib.search_entry(draws, B, p, n_valid, device=idx.device)


def recall(idx: OnlineIndex, q, draws, k: int = 10) -> float:
    """recall@k of a 2k-wide graph search against brute force over the live
    catalog (entry points from ``draws``)."""
    true_ids, _ = brute.brute_force_knn(idx.items, q, k, idx.metric, n_valid=idx.graph.n_valid,
                                        alive=idx.graph.alive, device=idx.device)
    res = idx.search(q, 2 * k, beam=64, seed_fn=searcher(idx, draws))
    return brute.recall_at_k(res.ids, true_ids, k)


def run(items, q, churn_rows, ingest_rows, *, build_draws, recall_draws, retrieve_draws,
        add_draws, pick, ingest_draws=None, path=None, device=None) -> dict:
    """The example's stages on ``items`` (N, d) and queries ``q``: the churn
    inserts ``churn_rows[i]`` after removing ``pick(alive_rows, m)`` in round
    i, keyed by ``add_draws[i]``; the coalesced ingest adds the rows of
    ``ingest_rows`` (``ingest_batch`` of them) one at a time, the last add's
    wave keyed by ``ingest_draws`` (None: the index's own default).  The
    snapshot goes to ``path`` (None: a temporary directory).  Returns what it
    printed and the ids and index it made."""
    dev = device_lib.resolve(device)
    items, q = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (items, q))
    n = items.shape[0]

    # -- build: online LGD construction, no capacity headroom on purpose ----
    _sync(dev)
    t0 = time.perf_counter()
    idx = retrieval.build_index(items, k=K, metric="l2", wave=512, device=dev,
                                seed_fn=draws_lib.wave_seed_fn(build_draws, BuildConfig().n_seeds,
                                                               device=dev))
    _sync(dev)
    build_s = time.perf_counter() - t0
    recall_build = recall(idx, q, recall_draws)
    print(f"built {n}-item index in {build_s:.3f}s on {dev} (capacity {idx.capacity}), "
          f"recall@10 {recall_build:.4f}")

    # -- snapshot -> restore: the serving-replica handoff --------------------
    with tempfile.TemporaryDirectory(prefix="knn_snapshot_") as tmp:
        snap = path or tmp
        t0 = time.perf_counter()
        idx.save(snap)
        replica = OnlineIndex.load(snap, device=dev)
        ids_a, _ = retrieval.retrieve(idx, q[:4], 10, seed_fn=searcher(idx, retrieve_draws))
        ids_b, _ = retrieval.retrieve(replica, q[:4], 10,
                                      seed_fn=searcher(replica, retrieve_draws))
        snapshot_s = time.perf_counter() - t0
    assert torch.equal(ids_a, ids_b)
    print(f"snapshot round trip in {snapshot_s:.3f}s — restored replica serves "
          f"bit-identical results")

    # -- churn: interleaved withdraw/list at FIXED capacity -------------------
    # removals feed the free-slot ledger; the next over-capacity insert
    # recycles those slots via compact() instead of growing the arrays
    p = replica.build_cfg.n_seeds
    _sync(dev)
    t0 = time.perf_counter()
    for step, rows in enumerate(churn_rows):
        alive = np.flatnonzero(replica.graph.alive.cpu().numpy())
        replica.remove(pick(alive, rows.shape[0]))
        replica.add(rows, seed_fn=draws_lib.wave_seed_fn(add_draws[step], p, device=dev),
                    flush=True)
    _sync(dev)
    churn_s = time.perf_counter() - t0
    capacity = replica.capacity
    assert capacity == n  # recycled, never grew
    recall_churn = recall(replica, q, recall_draws)
    print(f"{len(churn_rows)} rounds of {churn_rows[0].shape[0]}-out/"
          f"{churn_rows[0].shape[0]}-in churn in {churn_s:.3f}s at fixed capacity "
          f"{replica.capacity}, recall@10 {recall_churn:.4f}")

    # -- micro-batched ingest: trickling inserts coalesce into one wave -------
    ingest_rows = torch.as_tensor(ingest_rows, dtype=torch.float32).to(dev)
    assert ingest_rows.shape[0] == replica.ingest_batch
    n_before = replica.graph.n_valid
    for row in ingest_rows[:-1]:
        replica.add(row[None, :])
    buffered = replica.n_pending
    assert buffered == replica.ingest_batch - 1 and replica.graph.n_valid == n_before
    print(f"{buffered} single-item adds buffered (graph untouched: n_valid {n_before})")
    seed_fn = None if ingest_draws is None else draws_lib.wave_seed_fn(ingest_draws, p,
                                                                        device=dev)
    replica.add(ingest_rows[-1:], seed_fn=seed_fn)
    n_after = replica.graph.n_valid
    assert replica.n_pending == 0 and n_after == n_before + replica.ingest_batch
    print(f"threshold hit -> ONE coalesced insertion wave (n_valid {n_before} -> {n_after})")

    # -- explicit compact: reclaim the tail after a big withdrawal ------------
    alive = np.flatnonzero(replica.graph.alive.cpu().numpy())
    replica.remove(alive[: len(alive) // 4])
    free = replica.free_slots
    print(f"withdrew 25%: {free} slots in the free ledger")
    id_map = replica.compact()
    moved = int((id_map >= 0).sum())
    reclaimed = replica.capacity - replica.graph.n_valid
    recall_compact = recall(replica, q, recall_draws)
    print(f"compact(): {moved} alive rows re-packed, {reclaimed} slots reclaimed, "
          f"recall@10 {recall_compact:.4f}")
    return {"device": str(dev), "build_s": build_s, "recall_build": recall_build,
            "snapshot_s": snapshot_s, "churn_s": churn_s, "recall_churn": recall_churn,
            "capacity": capacity, "buffered": buffered, "n_before": n_before,
            "n_after": n_after, "free_slots": free, "moved": moved, "reclaimed": reclaimed,
            "recall_compact": recall_compact, "retrieved": ids_a, "index": replica,
            "id_map": id_map}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"), help="default: cuda")
    ap.add_argument("--tiny", action="store_true", help="the CPU test's size")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    size = TINY if args.tiny else dict(n=N, churn=CHURN)
    n, m = size["n"], size["churn"]

    def normal(seed, rows):
        return torch.randn((rows, D), generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    host = torch.Generator().manual_seed(3)

    def pick(alive, count):
        return alive[torch.randperm(len(alive), generator=host)[:count].numpy()]

    ingest_batch = OnlineIndex.__dataclass_fields__["ingest_batch"].default
    return run(normal(0, n), normal(1, N_QUERIES),
               [normal(10 + s, m) for s in range(CHURN_ROUNDS)], normal(100, ingest_batch),
               build_draws=draws_lib.TorchDraws(2), recall_draws=draws_lib.TorchDraws(5),
               retrieve_draws=draws_lib.TorchDraws(7),
               add_draws=[draws_lib.TorchDraws(20 + s) for s in range(CHURN_ROUNDS)],
               pick=pick, device=dev)


if __name__ == "__main__":
    main()
