"""Tiled exact k-NN (counterpart of ``repro.core.brute``).

Ground truth for recall@k (Eq. 1), the exact seed graph over the first
|I| = 256 rows (Alg. 2 lines 4-6), and the exhaustive baseline.  The x side
is walked in tiles with a running top-k, each tile one ``pairwise_distance``
call and one ``tile_topk`` call, so the (m, n) matrix never materializes.
With a tracker (``obs``) each tile is a ``brute/tile`` span with the
children ``brute/pairwise`` (the tile's distances) and ``brute/topk`` (the
masked running top-k); none of them waits for the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.kernels import ops
from repro_torch.obs import NOOP


def brute_force_knn(
    x: torch.Tensor,
    q: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    exclude_ids: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    alive: Optional[torch.Tensor] = None,
    tile: int = 8192,
    sq_norms: Optional[torch.Tensor] = None,
    device=None,
    tracker=None,
):
    """Exact top-k neighbours of the rows of q among the rows of x.

    Args:
      x: (n, d) dataset; q: (m, d) queries.
      exclude_ids: optional (m,) id per query to leave out (the self-match).
      n_valid: only rows [0, n_valid) take part.
      alive: optional (n,) bool; dead rows take no part.
      sq_norms: optional (n,) cached ``‖x‖²``, handed to each tile.
      device: where to run; None is the card (raises without one).
      tracker: an ``obs`` tracker for the per-tile spans (None: none).

    Returns ids (m, k) int32 and dists (m, k) float32, ascending; a row with
    fewer than k candidates is padded with (+inf, and the lowest-position
    masked ids) exactly as the reference pads.
    """
    dev = device_lib.resolve(device)
    x, q = x.to(dev), q.to(dev)
    n = x.shape[0]
    m = q.shape[0]
    tile = min(tile, n)
    ntiles = -(-n // tile)
    n_valid = n if n_valid is None else int(n_valid)
    best_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    excl = None if exclude_ids is None else exclude_ids.to(dev, torch.int64)
    alive = None if alive is None else alive.to(dev)
    trk = tracker or NOOP
    for t in range(ntiles):
        with trk.span("brute/tile"):
            lo = t * tile
            xt = x[lo:lo + tile]
            xn_t = None if sq_norms is None else sq_norms.to(dev)[lo:lo + tile].float()
            short = tile - xt.shape[0]
            if short:  # the reference pads the last tile with zero rows
                xt = torch.cat([xt, xt.new_zeros((short, xt.shape[1]))])
                if xn_t is not None:
                    xn_t = torch.cat([xn_t, xn_t.new_zeros(short)])
            with trk.span("brute/pairwise"):
                dt = ops.pairwise_distance(q, xt, metric, x_sq_norms=xn_t)
            with trk.span("brute/topk"):
                best_d, best_i = ops.tile_topk(
                    dt, best_d, best_i, lo, n_valid,
                    alive=None if alive is None else alive[lo:lo + tile], exclude_ids=excl)
    return best_i, best_d


def exact_seed_graph(
    x: torch.Tensor,
    n_seed: int,
    k: int,
    metric: str = "l2",
    *,
    capacity: Optional[int] = None,
    rev_capacity: Optional[int] = None,
    device=None,
) -> graph_lib.KNNGraph:
    """Exact k-NN graph over the first n_seed rows (Alg. 2 lines 4-6); rows
    beyond stay unallocated and the reverse lists derive from the forward
    lists."""
    dev = device_lib.resolve(device)
    x = x.to(dev)
    if capacity is None:
        capacity = x.shape[0]
    g = graph_lib.empty_graph(capacity, k, rev_capacity, device=dev)
    seeds = x[:n_seed]
    seed_sq = graph_lib.squared_norms(seeds)
    seed_sc = graph_lib.row_scales(seeds)
    ids, dists = brute_force_knn(
        seeds, seeds, min(k, n_seed - 1), metric,
        exclude_ids=torch.arange(n_seed, dtype=torch.int32, device=dev),
        sq_norms=seed_sq, device=dev,
    )
    kk = ids.shape[1]
    g.nbr_ids[:n_seed, :kk] = ids
    g.nbr_dist[:n_seed, :kk] = dists
    g.alive[:n_seed] = True
    g.sq_norms[:n_seed] = seed_sq
    g.row_scale[:n_seed] = seed_sc
    return graph_lib.rebuild_reverse(g._replace(n_valid=n_seed))


def recall_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor, k: int) -> float:
    """Eq. 1: |pred ∩ true| / (m k) over top-k lists."""
    p = pred_ids[:, :k, None]
    hits = ((p == true_ids[:, None, :k]) & (p >= 0)).sum()
    return int(hits) / (pred_ids.shape[0] * k)
