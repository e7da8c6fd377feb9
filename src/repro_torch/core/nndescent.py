"""NN-Descent (Dong et al., WWW'11), the paper's primary baseline, and the
refinement sweep of the divide-and-conquer build (counterpart of
``repro.core.nndescent``).

The batched formulation with the two optimizations of the original:
incremental search (new/old flags: only pairs touching a new entry are
joined) and reverse sampling (bounded reverse-neighbour participation).
A join round walks the nodes in chunks of ``node_chunk``: each chunk's
(C, C) member tiles (``core.metrics.pairwise``) propose candidate pairs in
both directions, and ``merge.merge_candidates`` commits them over the whole
graph before the next chunk.  ``local_join_refine`` is the §IV-D pass, join
rounds over an already built graph with every entry new, followed by the
canonical λ of the final lists (``recompute_lambda``); ``refine`` is the
bounded sweep ``construct.build_parallel`` runs after its merges.

The random initial lists draw from a ``core.draws.Draws``; their distances
go through ``ops.gather_distance``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import merge, metrics, segments
from repro_torch.core.draws import TorchDraws
from repro_torch.core.graph import KNNGraph, rebuild_reverse
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class NNDescentConfig:
    k: int = 20
    metric: str = "l2"
    max_iters: int = 12
    delta: float = 0.001  # stop when updates < delta * n * k
    rev_sample: Optional[int] = None  # reverse neighbours joined per node (default k)
    node_chunk: int = 2048  # nodes per local-join tile (bounds the (B, C, C) buffer)


class NNDescentState(NamedTuple):
    ids: torch.Tensor  # (n, k)
    dist: torch.Tensor  # (n, k)
    is_new: torch.Tensor  # (n, k) — entry not yet joined


def _random_init(x: torch.Tensor, k: int, metric: str, draws) -> NNDescentState:
    """k + 4 uniform draws per node, self and repeated ids masked, the k
    nearest kept."""
    n = x.shape[0]
    ids = draws.randint((n, k + 4), n, x.device)
    row = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    ids = torch.where(ids == row, -1, ids)
    ids = torch.where(segments.mask_row_duplicates(ids), -1, ids)
    d = ops.gather_distance(x, x, ids, metric)
    d, ids = ops.topk_smallest(d, ids, k)
    ids = torch.where(torch.isfinite(d), ids, -1)
    return NNDescentState(ids=ids, dist=torch.where(ids >= 0, d, float("inf")), is_new=ids >= 0)


def _reverse_sample(ids: torch.Tensor, is_new: torch.Tensor, r: int):
    """Bounded reverse lists with their new/old flags: (n, r) each, the
    first r owners of each node in owner order."""
    n, k = ids.shape
    owners = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None].expand(n, k)
    flat_m = torch.where(ids >= 0, ids, n).reshape(-1)
    order = torch.argsort(flat_m, stable=True)
    (rev_ids, rev_new), _ = segments.grouped_top_r(
        flat_m[order], [owners.reshape(-1)[order], is_new.reshape(-1)[order]], [-1, False], n, r
    )
    return rev_ids, rev_new


def _local_join_chunk(x, cand_ids, cand_new, metric):
    """Every (new x any) pair inside each node's candidate list (B, C):
    flat proposals (v, q, d) of length 2·B·C·C in both directions, -1 /
    +inf where not joinable, and the distances computed (0-d int64)."""
    B, C = cand_ids.shape
    vec = x[cand_ids.clamp_min(0).long()]  # (B, C, d)
    dmat = metrics.pairwise(metric, vec, vec)  # (B, C, C)
    valid = (cand_ids[:, :, None] >= 0) & (cand_ids[:, None, :] >= 0)
    upper = torch.ones((C, C), dtype=torch.bool, device=x.device).triu(1)[None]
    joinable = valid & upper & (cand_new[:, :, None] | cand_new[:, None, :])
    # a pair of equal ids (one id in the forward and the reverse list)
    joinable &= cand_ids[:, :, None] != cand_ids[:, None, :]
    a = torch.where(joinable, cand_ids[:, :, None].expand(B, C, C), -1).reshape(-1)
    b = torch.where(joinable, cand_ids[:, None, :].expand(B, C, C), -1).reshape(-1)
    d = torch.where(joinable, dmat, float("inf")).reshape(-1)
    return torch.cat([a, b]), torch.cat([b, a]), torch.cat([d, d]), joinable.sum()


def recompute_lambda(
    ids: torch.Tensor, dist: torch.Tensor, x: torch.Tensor, metric: str, *,
    node_chunk: int = 2048,
) -> tuple[torch.Tensor, int]:
    """Canonical λ of sorted neighbour lists, in chunks of rows:
    λ(j_i ∈ G[v]) = #{l < i : m(j_l, j_i) < m(v, j_i)}, m(v, j_i) read off
    ``dist``, the member pairs computed here and charged.  Returns ((n, k)
    int32 λ, comps as an int)."""
    n, k = ids.shape
    earlier = torch.ones((k, k), dtype=torch.bool, device=ids.device).triu(1)[None]
    lams = []
    comps = torch.zeros((), dtype=torch.int64, device=ids.device)
    for lo in range(0, n, node_chunk):
        ci, cd = ids[lo:lo + node_chunk], dist[lo:lo + node_chunk]
        vec = x[ci.clamp_min(0).long()]
        dmat = metrics.pairwise(metric, vec, vec)
        valid = (ci[:, :, None] >= 0) & (ci[:, None, :] >= 0) & earlier
        lam = (valid & (dmat < cd[:, None, :])).sum(dim=1).to(torch.int32)
        lams.append(torch.where(ci >= 0, lam, 0))
        comps = comps + valid.sum()
    if not lams:
        return torch.zeros_like(ids), 0
    return torch.cat(lams), int(comps)


def _join_round(x, ids, dist, is_new, rev_ids, rev_new, metric: str, chunk_size: int):
    """One join round over the nodes in chunks, each chunk's proposals
    committed before the next.  Carried entries keep their flag, fresh
    inserts are new, and the joined chunk's forward entries become old.
    Returns (ids, dist, is_new, comps, inserted), the counts 0-d int64."""
    n = ids.shape[0]
    cand_ids = torch.cat([ids, rev_ids], dim=1)
    cand_new = torch.cat([is_new, rev_new], dim=1)
    lam0 = torch.zeros_like(ids)
    rows = torch.arange(n, device=ids.device)
    total = torch.zeros((), dtype=torch.int64, device=ids.device)
    inserted = torch.zeros((), dtype=torch.int64, device=ids.device)
    for lo in range(0, n, chunk_size):
        v, q, d, nc = _local_join_chunk(
            x, cand_ids[lo:lo + chunk_size], cand_new[lo:lo + chunk_size], metric)
        res = merge.merge_candidates(ids, dist, lam0, v, q, d)
        carried = torch.where(
            res.old_slot >= 0, torch.gather(is_new, 1, res.old_slot.clamp_min(0).long()), False)
        in_chunk = (rows >= lo) & (rows < lo + chunk_size)
        is_new = res.is_new | (carried & ~in_chunk[:, None])
        ids, dist = res.nbr_ids, res.nbr_dist
        total = total + nc
        inserted = inserted + res.n_inserted
    return ids, dist, is_new, total, inserted


def build(
    x: torch.Tensor, cfg: NNDescentConfig, draws=None, *, device=None,
) -> tuple[KNNGraph, dict]:
    """Run NN-Descent to convergence from random lists drawn from ``draws``
    (a ``core.draws.Draws``, default ``TorchDraws(0)``).  ``device``: where
    to run (None: the card, raising without one).  Returns (graph, stats)."""
    dev = device_lib.resolve(device)
    x = x.to(dev).float()
    n, k = x.shape[0], cfg.k
    st = _random_init(x, k, cfg.metric, TorchDraws(0) if draws is None else draws)
    total_comps = float(n * k)
    r = cfg.rev_sample or k
    updates = []
    for _ in range(cfg.max_iters):
        rev_ids, rev_new = _reverse_sample(st.ids, st.is_new, r)
        ids, dist, is_new, comps, upd = _join_round(
            x, st.ids, st.dist, st.is_new, rev_ids, rev_new, cfg.metric, cfg.node_chunk)
        st = NNDescentState(ids=ids, dist=dist, is_new=is_new)
        total_comps += float(comps)
        updates.append(int(upd))
        if updates[-1] < cfg.delta * n * k:
            break
    g = KNNGraph(
        nbr_ids=st.ids,
        nbr_dist=st.dist,
        nbr_lam=torch.zeros_like(st.ids),
        rev_ids=torch.full((n, 2 * k), -1, dtype=torch.int32, device=dev),
        rev_lam=torch.zeros((n, 2 * k), dtype=torch.int32, device=dev),
        rev_ptr=torch.zeros((n,), dtype=torch.int32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        n_valid=n,
        sq_norms=graph_lib.squared_norms(x),
        row_scale=graph_lib.row_scales(x),
    )
    stats = {
        "n_comps": total_comps,
        "scanning_rate": total_comps / (n * (n - 1) / 2.0),
        "iters": len(updates),
        "updates": updates,
    }
    return rebuild_reverse(g), stats


def local_join_refine(
    g: KNNGraph, x: torch.Tensor, metric: str = "l2", *, rounds: int = 1,
    node_chunk: int = 2048,
) -> tuple[KNNGraph, int]:
    """§IV-D refinement: join rounds over an existing graph with every entry
    new, then the canonical λ of the refined lists and the reverse lists
    rebuilt from them.  Returns (graph, comps of the rounds and the λ
    recompute as an int)."""
    ids, dist = g.nbr_ids, g.nbr_dist
    is_new = ids >= 0
    comps = 0
    for _ in range(rounds):
        rev_ids, rev_new = _reverse_sample(ids, is_new, g.k)
        ids, dist, is_new, c, _ = _join_round(
            x, ids, dist, is_new, rev_ids, rev_new, metric, node_chunk)
        comps += int(c)
    lam, lam_comps = recompute_lambda(ids, dist, x, metric, node_chunk=node_chunk)
    g = g._replace(nbr_ids=ids, nbr_dist=dist, nbr_lam=lam)
    return rebuild_reverse(g), comps + lam_comps


def refine(
    g: KNNGraph, x: torch.Tensor, metric: str = "l2", *, rounds: int = 1,
    node_chunk: int = 2048,
) -> tuple[KNNGraph, int]:
    """The bounded refinement sweep after a merge: ``rounds`` join rounds
    (0 returns ``g`` and 0 comps)."""
    if rounds <= 0:
        return g, 0
    return local_join_refine(g, x, metric, rounds=rounds, node_chunk=node_chunk)
