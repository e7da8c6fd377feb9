"""ANN retrieval serving over an ``OnlineIndex`` (counterpart of
``repro.serve.retrieval``).

Item vectors are indexed once with the online LGD build; at serve time each
request's query vectors (a user's interests) search the graph, and the
results of its queries are deduplicated and merged.  Catalog churn maps to
the index's insert and remove, with no rebuild.  ``add_items`` and
``remove_items`` are functional: they mutate a clone (which shares tensors
until it replaces them) and leave their argument as it was.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import brute, construct, segments
from repro_torch.index.lifecycle import OnlineIndex

#: metrics whose distance is a negated similarity: the score flips its sign
SIMILARITY_METRICS = ("ip", "cosine")


def score_from_dist(dist: torch.Tensor, metric: str) -> torch.Tensor:
    """Serving score: higher is better for similarity metrics (ip, cosine),
    the plain distance (lower is better) otherwise.  An involution."""
    return -dist if metric in SIMILARITY_METRICS else dist


def build_index(
    items,
    *,
    k: int = 20,
    metric: str = "ip",
    wave: int = 512,
    capacity: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    seed_fn: Optional[construct.SeedFn] = None,
    beam: int = 40,
    precision: str = "fp32",
    device=None,
) -> OnlineIndex:
    """Index a candidate bank with the online LGD build; entry points from
    ``seed_fn`` (build-shaped), else from ``generator``."""
    cfg = construct.BuildConfig(
        k=k, metric=metric, wave=wave, lgd=True, beam=beam, precision=precision
    )
    return OnlineIndex.build(items, cfg, capacity=capacity, generator=generator,
                             seed_fn=seed_fn, device=device)


def _merge_queries(ids: torch.Tensor, dist: torch.Tensor, top_k: int, metric: str):
    """Flatten a request's (m, k) results, keep each id's best copy and the
    top_k overall: (ids, scores)."""
    ids, dist = ids.reshape(-1), dist.reshape(-1)
    order = torch.argsort(dist, stable=True)
    ids_s = ids[order]
    dup = segments.mask_row_duplicates(ids_s[None, :])[0]
    dist_s = torch.where(dup | (ids_s < 0), float("inf"), dist[order])
    sel = torch.argsort(dist_s, stable=True)[:top_k]
    return ids_s[sel], score_from_dist(dist_s[sel], metric)


def retrieve(
    index: OnlineIndex,
    interests,
    top_k: int,
    *,
    beam: Optional[int] = None,
    seed_fn=None,
    generator: Optional[torch.Generator] = None,
    with_stats: bool = False,
):
    """k-NN retrieval: an EHC search per query of ``interests`` (m, d), then
    the cross-query dedupe and merge.  Returns (ids (top_k,), scores), plus
    the raw ``SearchResult`` with ``with_stats``."""
    res = index.search(interests, top_k, beam=beam, seed_fn=seed_fn, generator=generator)
    out_ids, scores = _merge_queries(res.ids, res.dists, top_k, index.metric)
    if with_stats:
        return out_ids, scores, res
    return out_ids, scores


def retrieve_brute(index: OnlineIndex, interests, top_k: int):
    """The exact answer over the live catalog (buffered adds flushed,
    removed rows masked): the oracle of ``retrieve``."""
    index.flush()
    q = torch.as_tensor(interests, dtype=torch.float32).to(index.device)
    ids, dist = brute.brute_force_knn(
        index.items, q, top_k, index.metric, n_valid=index.graph.n_valid,
        alive=index.graph.alive, device=index.device,
    )
    return _merge_queries(ids, dist, top_k, index.metric)


def add_items(index: OnlineIndex, new_items, seed_fn=None) -> OnlineIndex:
    """Catalog insert (§IV-C); returns a new index, the argument untouched.
    Past capacity the index recycles free slots or grows."""
    return index.clone().add(new_items, seed_fn=seed_fn, flush=True)


def remove_items(index: OnlineIndex, ids) -> OnlineIndex:
    """Catalog withdrawal with the λ repair; returns a new index, the
    argument untouched."""
    return index.clone().remove(ids)
