"""Dynamic updates — §IV-C: rows join and leave the graph online
(counterpart of ``repro.core.dynamic``).

Insertion is the construction step: ``insert`` runs more waves of
``construct.build`` over the existing graph.  Removal follows the paper:
the row is dropped (list released, ``alive`` cleared), it is purged from
every forward and reverse list, and the LGD λ of the members ranked after
it in each list it left is repaired (the undo of Rule 3), from distances
recomputed on the spot.  ``compact`` re-packs the alive rows to the front so
that sustained churn does not leak capacity.

All three leave their inputs untouched and return new tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import construct as construct_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.graph import KNNGraph

# affected rows per λ-repair chunk: (rows, k, d) member vectors at a time
_REPAIR_ROWS = 16384


def insert(
    g: KNNGraph,
    x: torch.Tensor,
    n_new: int,
    cfg: construct_lib.BuildConfig,
    *,
    seed_fn=None,
    generator: Optional[torch.Generator] = None,
    coarse=None,
    landmark_rows: Optional[torch.Tensor] = None,
    landmark_seed_fn=None,
    device=None,
):
    """Insert rows [n_valid, n_valid + n_new) of x into the graph online.

    ``x`` is the (capacity, d) data region with the new rows already written
    at their rows.  Entry points come from ``seed_fn`` (as in
    ``construct.build``), else from ``generator``, which defaults to one
    seeded with the first new row's index.  Returns (graph, stats), or
    (graph, stats, coarse) when a ``coarse`` level is passed or
    ``cfg.seed_mode == "coarse"`` (a level is then derived when missing).
    """
    dev = device_lib.resolve(device)
    start = g.n_valid
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(start)
    with_coarse = coarse is not None or cfg.seed_mode == "coarse"
    return construct_lib.build(
        x[: start + n_new], cfg, generator=generator, seed_fn=seed_fn,
        initial=(g, start), coarse=coarse, return_coarse=with_coarse,
        landmark_rows=landmark_rows, landmark_seed_fn=landmark_seed_fn, device=dev,
    )


def _lambda_decrements(g: KNNGraph, x: torch.Tensor, hit: torch.Tensor, metric: str):
    """(cap, k) λ decrements of the Rule-3 undo: in row r, a valid surviving
    member at slot j loses one count for each removed member at a slot
    s < j with m(x_j, x_s) < m(x_s, x_r).  Only rows holding a removed
    member can change, so only they are computed, in chunks."""
    cap, k = g.nbr_ids.shape
    dec = torch.zeros_like(g.nbr_lam)
    rows = torch.nonzero(hit.any(dim=1))[:, 0]
    slots = torch.arange(k, device=hit.device)
    later = slots[None, :] > slots[:, None]  # (s removed, j later)
    for lo in range(0, rows.numel(), _REPAIR_ROWS):
        r = rows[lo:lo + _REPAIR_ROWS]
        ids = g.nbr_ids[r]
        vecs = x[ids.clamp_min(0).long()]  # (R, k, d)
        dm = metrics_lib.pairwise(metric, vecs, vecs)  # (R, k, k)
        h = hit[r]
        undo = (
            h[:, :, None] & (ids >= 0)[:, None, :] & ~h[:, None, :] & later
            & (dm < g.nbr_dist[r][:, :, None])
        )
        dec[r] = undo.sum(dim=1).to(dec.dtype)
    return dec


def remove(
    g: KNNGraph,
    x: torch.Tensor,
    ids: torch.Tensor,
    metric: str = "l2",
    *,
    repair_lambda: bool = True,
) -> KNNGraph:
    """Remove rows ``ids`` (m,) from the graph; out-of-range ids and -1
    padding are ignored.  Rows that lose members keep holes at the tail
    (re-packed with a stable sort); removed rows are cleared, purged from
    every reverse list, and their caches drop to 0."""
    cap, k = g.nbr_ids.shape
    dev = g.nbr_ids.device
    ids = torch.as_tensor(ids).to(device=dev, dtype=torch.int64).reshape(-1)
    ids = ids[(ids >= 0) & (ids < cap)]
    removed = torch.zeros(cap, dtype=torch.bool, device=dev)
    removed[ids] = True

    hit = (g.nbr_ids >= 0) & removed[g.nbr_ids.clamp_min(0).long()]
    nbr_lam = g.nbr_lam
    if repair_lambda:
        nbr_lam = (nbr_lam - _lambda_decrements(g, x.to(dev), hit, metric)).clamp_min(0)

    # purge removed members and re-pack the rows (stable: order kept)
    dist = torch.where(hit, float("inf"), g.nbr_dist)
    idsx = torch.where(hit, -1, g.nbr_ids)
    lam = torch.where(hit, 0, nbr_lam)
    order = torch.argsort(torch.where(idsx >= 0, dist, float("inf")), dim=1, stable=True)
    nbr_ids = torch.gather(idsx, 1, order)
    nbr_dist = torch.where(nbr_ids >= 0, torch.gather(dist, 1, order), float("inf"))
    nbr_lam = torch.where(nbr_ids >= 0, torch.gather(lam, 1, order), 0)
    nbr_ids[ids], nbr_dist[ids], nbr_lam[ids] = -1, float("inf"), 0

    # purge from the reverse lists (the rings keep their counters)
    rev_hit = (g.rev_ids >= 0) & removed[g.rev_ids.clamp_min(0).long()]
    rev_ids = torch.where(rev_hit, -1, g.rev_ids)
    rev_lam = torch.where(rev_hit, 0, g.rev_lam)
    rev_ids[ids], rev_lam[ids] = -1, 0
    rev_ptr, alive = g.rev_ptr.clone(), g.alive.clone()
    rev_ptr[ids], alive[ids] = 0, False
    return KNNGraph(
        nbr_ids=nbr_ids,
        nbr_dist=nbr_dist,
        nbr_lam=nbr_lam,
        rev_ids=rev_ids,
        rev_lam=rev_lam,
        rev_ptr=rev_ptr,
        alive=alive,
        n_valid=g.n_valid,
        sq_norms=torch.where(removed, 0.0, g.sq_norms),
        row_scale=torch.where(removed, 0.0, g.row_scale),
    )


def compact(g: KNNGraph, x: torch.Tensor) -> tuple[KNNGraph, torch.Tensor, torch.Tensor]:
    """Re-pack the alive rows to rows [0, n_alive), keeping their order.

    ``id_map`` (old row -> new row, -1 for dead) is a prefix sum over the
    alive mask, and its inverse one scatter; every row array is gathered
    through the inverse, stored ids are remapped through ``id_map``, and the
    reverse side is rebuilt canonically (``graph.rebuild_reverse``).  The
    caches move with their rows, never recomputed.  Capacity is unchanged.

    Returns (graph, the re-packed (cap, d) data, (cap,) int32 id_map).
    """
    cap = g.capacity
    dev = g.nbr_ids.device
    x = x.to(dev)
    row = torch.arange(cap, dtype=torch.int32, device=dev)
    alive = g.alive & (row < g.n_valid)
    n_alive = int(alive.sum())
    id_map = torch.where(alive, torch.cumsum(alive.to(torch.int32), 0) - 1, -1).to(torch.int32)
    old_of_new = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    old_of_new[torch.where(alive, id_map, cap).long()] = row
    old_of_new = old_of_new[:cap]
    filled = old_of_new >= 0
    src = old_of_new.clamp_min(0).long()

    def pack(a, fill):
        mask = filled if a.dim() == 1 else filled[:, None]
        return torch.where(mask, a[src], fill)

    nbr_ids = pack(g.nbr_ids, -1)
    nbr_ids = torch.where(nbr_ids >= 0, id_map[nbr_ids.clamp_min(0).long()], -1)
    g2 = KNNGraph(
        nbr_ids=nbr_ids,
        nbr_dist=torch.where(nbr_ids >= 0, pack(g.nbr_dist, float("inf")), float("inf")),
        nbr_lam=torch.where(nbr_ids >= 0, pack(g.nbr_lam, 0), 0),
        rev_ids=torch.full_like(g.rev_ids, -1),
        rev_lam=torch.zeros_like(g.rev_lam),
        rev_ptr=torch.zeros_like(g.rev_ptr),
        alive=filled,
        n_valid=n_alive,
        sq_norms=pack(g.sq_norms, 0.0),
        row_scale=pack(g.row_scale, 0.0),
    )
    return graph_lib.rebuild_reverse(g2), pack(x, 0.0), id_map
