"""End-to-end retrieval serving on the PyTorch port: MIND interests into an
LGD-graph ANN index (the counterpart of ``examples/retrieval_serving.py``).

    PYTHONPATH=src python examples/retrieval_serving_torch.py            # on the card
    PYTHONPATH=src python examples/retrieval_serving_torch.py --device cpu --n-items 2000

The paper's own production scenario (§IV-C e-shopping): a live item catalog
indexed by online LGD construction, queried by the MIND recommender's
interest vectors, with items joining and leaving the catalog and no
rebuild.  Each user's 4 interests are served through the graph
(``retrieve``) and against exact retrieval over the same index
(``retrieve_brute``); overlap@20 between the two is printed per run, mean
and minimum over the users.

By default the encoder has the example's own widths (d=16, 12-item
histories, MLP 32, a table of ``--n-items`` rows) and the index builds in
waves of 512; ``--full-config`` takes MIND's published widths
(``configs/mind.py``: d=64, 20-item histories, MLP 256, a 10^7-row table),
indexes the table's first ``--n-items`` rows and builds at the knn-lgd wave
of 4,096 (at 512 a 10^6-row build takes eight times the waves).
Parameters are random, drawn from seeded generators on the device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import mind
from repro_torch.models import recsys
from repro_torch.serve import retrieval

TOP_K, BEAM, USERS, ADDED, WITHDRAWN = 20, 48, 16, 300, 200


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def encoder_config(n_items: int, full: bool) -> recsys.RecsysConfig:
    if full:
        return mind.full_config()
    return recsys.RecsysConfig(name="mind", vocab_per_field=n_items, embed_dim=16,
                               n_interests=4, capsule_iters=3, mlp=(32,), seq_len=12)


def serve(index, interests: torch.Tensor) -> tuple:
    """One request per user: (graph ids, exact ids, seconds per request)."""
    got, exact, secs = [], [], []
    for q in interests:
        t0 = time.perf_counter()
        ids, _ = retrieval.retrieve(index, q, TOP_K, beam=BEAM)
        got.append(ids.tolist())  # the ids on the host: the card's work is done
        secs.append(time.perf_counter() - t0)
        exact.append(retrieval.retrieve_brute(index, q, TOP_K)[0].tolist())
    return got, exact, secs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--n-items", type=int, default=8000)
    ap.add_argument("--full-config", action="store_true",
                    help="MIND's published widths (d=64) and its 10^7-row table")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    n = args.n_items

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = encoder_config(n, args.full_config)
    if n > cfg.vocab_per_field:
        raise ValueError(f"--n-items {n} exceeds the table's {cfg.vocab_per_field} rows")
    params = recsys.init_params(gen(0), cfg)
    items = normalize(params["table"][:n])  # serve directly from the item table

    t0 = time.perf_counter()
    wave = 4096 if args.full_config else 512
    index = retrieval.build_index(items, k=16, metric="ip", wave=wave, capacity=n + 2000,
                                  generator=gen(1), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"indexed {n} items (d={cfg.embed_dim}) with online LGD on {dev} in {build_s:.3f}s")

    # users arrive: history -> 4 interest vectors -> ANN retrieval
    hist = torch.randint(0, n, (USERS, cfg.seq_len), generator=gen(2), device=dev)
    interests = normalize(recsys.mind_interests(params, hist, cfg))
    got, exact, secs = serve(index, interests)
    overlaps = [len(set(a) & set(b)) / TOP_K for a, b in zip(got, exact)]
    mean_overlap = sum(overlaps) / len(overlaps)
    secs_sorted = sorted(secs)
    print(f"top-{TOP_K} via the LGD graph for {USERS} users: overlap with exact "
          f"mean {mean_overlap:.4f}, min {min(overlaps):.4f}; "
          f"p50 {secs_sorted[len(secs) // 2] * 1e3:.3f} ms per request")

    # catalog churn: new products listed, old ones withdrawn, no rebuild
    new_items = normalize(torch.randn((ADDED, cfg.embed_dim), generator=gen(3), device=dev))
    index = retrieval.add_items(index, new_items)
    index = retrieval.remove_items(index, torch.arange(WITHDRAWN, device=dev))
    after, _, _ = serve(index, interests)
    leaked = sum(i < WITHDRAWN for ids in after for i in ids)
    if leaked:
        raise RuntimeError(f"{leaked} withdrawn items returned after the churn")
    print(f"catalog churn applied online: +{ADDED} / -{WITHDRAWN} items, retrieval still "
          f"serving (no withdrawn items returned)")
    return {"device": str(dev), "n_items": n, "d": cfg.embed_dim, "build_s": build_s,
            "overlap_mean": mean_overlap, "overlap_min": min(overlaps),
            "p50_ms": secs_sorted[len(secs) // 2] * 1e3, "ids": got, "ids_after_churn": after}


if __name__ == "__main__":
    main()
