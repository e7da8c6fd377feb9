"""Batched ``insertG``, reverse-list appends and the symmetric sub-graph
merge (counterpart of ``repro.core.merge``).

``merge_candidates`` commits a flat stream of (row, id, dist) candidate
edges into the k-NN lists: qualify, dedupe, rank per row, keep k per row,
then a row-wise merge of (old ‖ candidates).  The row-wise merge sorts a
(capacity, 2k) array over every row on every call, as the reference does.
``append_reverse`` is the batched FIFO ring-buffer append.  Both return new
tensors and leave their inputs untouched.

The divide-and-conquer half: ``symmetric_merge`` joins two fully allocated
sub-graphs (each side's rows search the other side's graph, the hits' own
lists are proposed as second-hop candidates through
``ops.merge_proposals``, every pair goes in both directions through
``merge_candidates``, and the reverse lists are rebuilt canonically), and
``merge_subgraphs`` folds S adjacent sub-graphs with a balanced tree of
such merges.  Entry points come from a ``core.draws.Draws`` with the
reference's key chain: pair i of level l draws from ``fold_in((l << 16) |
i)`` of the root, a merge splits its draws between the two sides, and
cross-search chunk i of a side draws from ``fold_in(i)`` of its half.  The
pairs of a level merge one after another on the one device, or, given a
process group (``mesh``), one pair per rank (``distributed.merge_pairs_mesh``,
whose cross searches draw once per side for the whole batch, as the
reference's mesh branch does).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import segments
from repro_torch.core.draws import TorchDraws, search_entry

# Second-hop expansion width of the merge proposals: only the nearest
# HOP_TOP cross-search hits donate their neighbour lists.
HOP_TOP = 20

# candidate edges per block of ``merge_candidates``' already-in-the-row test,
# which compares each candidate with its target row's k ids (a (T, k)
# array); per-candidate, so the blocks change no value
_PRESENT_BLOCK = 1 << 23


class MergeResult(NamedTuple):
    nbr_ids: torch.Tensor  # (cap, k) int32 merged lists
    nbr_dist: torch.Tensor  # (cap, k) float32
    nbr_lam: torch.Tensor  # (cap, k) int32 — carried for old entries, 0 for new
    is_new: torch.Tensor  # (cap, k) bool — slot filled by this merge
    old_slot: torch.Tensor  # (cap, k) int32 — original slot if carried, else -1
    cand_ids: torch.Tensor  # (cap, k) int32 — per-row qualified candidates
    cand_dist: torch.Tensor  # (cap, k) float32
    n_inserted: torch.Tensor  # () int64 — slots that changed


def lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Stable order by (primary, secondary), full ties by position —
    ``jnp.lexsort((secondary, primary))``."""
    o = torch.argsort(secondary, stable=True)
    return o[torch.argsort(primary[o], stable=True)]


def merge_candidates(
    nbr_ids: torch.Tensor,
    nbr_dist: torch.Tensor,
    nbr_lam: torch.Tensor,
    v: torch.Tensor,
    q: torch.Tensor,
    d: torch.Tensor,
) -> MergeResult:
    """Commit candidate edges v -> q with distance d (T,) into the lists;
    negative v is padding."""
    cap, k = nbr_ids.shape
    dev = nbr_ids.device
    v, q, d = v.to(torch.int32), q.to(torch.int32), d.float()

    # --- qualify -----------------------------------------------------------
    valid = (v >= 0) & (v < cap) & (q >= 0) & (q != v) & torch.isfinite(d)
    row = torch.where(valid, v, cap).clamp_max(cap - 1).long()
    kth = torch.where(valid, nbr_dist[row, k - 1], float("-inf"))
    valid &= d < kth
    present = torch.cat([  # already in the row
        (nbr_ids[row[lo:lo + _PRESENT_BLOCK]] == q[lo:lo + _PRESENT_BLOCK, None]).any(dim=1)
        for lo in range(0, max(row.shape[0], 1), _PRESENT_BLOCK)
    ])
    valid &= ~present

    # --- dedupe exact (v, q) duplicates -------------------------------------
    v1 = torch.where(valid, v, cap)
    q1 = torch.where(valid, q, cap)
    order1 = lexsort(q1, v1)
    sv1, sq1 = v1[order1], q1[order1]
    first = torch.zeros(1, dtype=torch.bool, device=dev)
    dup = torch.cat([first, (sv1[1:] == sv1[:-1]) & (sq1[1:] == sq1[:-1])])
    dup_unsorted = torch.zeros_like(dup)
    dup_unsorted[order1] = dup
    valid &= ~dup_unsorted

    # --- rank by (v, d), keep top-k per row ---------------------------------
    vv = torch.where(valid, v, cap)
    order2 = lexsort(d, vv)
    (cand_ids, cand_dist), _ = segments.grouped_top_r(
        vv[order2], [q[order2], d[order2]], [-1, float("inf")], cap, k
    )

    # --- row-wise merge: top-k of (old ‖ candidates), old first on ties -----
    all_ids = torch.cat([nbr_ids, cand_ids], dim=1)  # (cap, 2k)
    all_dist = torch.cat([nbr_dist, cand_dist], dim=1)
    all_lam = torch.cat([nbr_lam, torch.zeros_like(nbr_lam)], dim=1)
    key = torch.where(all_ids >= 0, all_dist, float("inf"))
    origin = torch.argsort(key, dim=1, stable=True)[:, :k]
    m_ids = torch.gather(all_ids, 1, origin)
    m_dist = torch.gather(all_dist, 1, origin)
    m_lam = torch.gather(all_lam, 1, origin)
    is_new = (origin >= k) & (m_ids >= 0)
    old_slot = torch.where(origin < k, origin, -1).to(torch.int32)
    m_lam = torch.where(is_new, 0, m_lam)
    return MergeResult(
        nbr_ids=m_ids, nbr_dist=m_dist, nbr_lam=m_lam, is_new=is_new,
        old_slot=old_slot, cand_ids=cand_ids, cand_dist=cand_dist,
        n_inserted=is_new.sum(),
    )


def append_reverse(
    rev_ids: torch.Tensor,
    rev_lam: torch.Tensor,
    rev_ptr: torch.Tensor,
    owner: torch.Tensor,
    member: torch.Tensor,
    lam: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Owner joins the reverse list of member (T,), member < 0 is padding;
    ``lam`` is the forward twin's λ (default 0).  When more than R appends
    hit one member in a batch, the last R are kept (FIFO overwrite)."""
    cap, R = rev_ids.shape
    if lam is None:
        lam = torch.zeros_like(owner)
    valid = (member >= 0) & (member < cap) & (owner >= 0)
    m = torch.where(valid, member, cap)
    order = torch.argsort(m, stable=True)
    sm = m[order]
    so = torch.where(valid, owner, -1)[order]
    sl = torch.where(valid, lam.to(torch.int32), 0)[order]
    rank = segments.segment_rank(sm)
    counts = segments.segment_counts(sm, cap)
    srow = sm.clamp_max(cap - 1).long()
    cnt_e = torch.where(sm < cap, counts[srow], 0)
    ok = (sm < cap) & (rank >= cnt_e - R)
    slot = (rev_ptr[srow] + rank) % R
    rev_ids = segments.scatter_rows(rev_ids, sm, slot, so, ok)
    rev_lam = segments.scatter_rows(rev_lam, sm, slot, sl, ok)
    return rev_ids, rev_lam, rev_ptr + counts


# ---------------------------------------------------------------------------
# Symmetric sub-graph merge (divide-and-conquer construction)
# ---------------------------------------------------------------------------


def _check_allocated(g_a, g_b, what: str) -> None:
    if g_a.n_valid != g_a.capacity or g_b.n_valid != g_b.capacity:
        raise ValueError(
            f"{what} needs fully-allocated sub-graphs (n_valid == capacity); got "
            f"{g_a.n_valid}/{g_a.capacity} and {g_b.n_valid}/{g_b.capacity} — compact first"
        )


def stack_subgraphs(g_a, g_b, n_a: int):
    """Concatenate two fully allocated sub-graphs into one id space: ``g_a``
    covers rows [0, n_a), ``g_b``'s local rows become [n_a, n_a + n_b).
    Forward ids of b are offset, the reverse side is left empty (callers
    rebuild it), and the norm and scale caches are concatenated, never
    recomputed."""
    _check_allocated(g_a, g_b, "stack_subgraphs")
    return _stack_core(g_a, g_b)


def _stack_core(g_a, g_b):
    from repro_torch.core.graph import KNNGraph  # graph does not import merge

    n_a, n_b = g_a.capacity, g_b.capacity
    R = max(g_a.rev_capacity, g_b.rev_capacity)
    cap = n_a + n_b
    dev = g_a.nbr_ids.device
    return KNNGraph(
        nbr_ids=torch.cat([g_a.nbr_ids, torch.where(g_b.nbr_ids >= 0, g_b.nbr_ids + n_a, -1)]),
        nbr_dist=torch.cat([g_a.nbr_dist, g_b.nbr_dist]),
        nbr_lam=torch.cat([g_a.nbr_lam, g_b.nbr_lam]),
        rev_ids=torch.full((cap, R), -1, dtype=torch.int32, device=dev),
        rev_lam=torch.zeros((cap, R), dtype=torch.int32, device=dev),
        rev_ptr=torch.zeros((cap,), dtype=torch.int32, device=dev),
        alive=torch.cat([g_a.alive, g_b.alive]),
        n_valid=cap,
        sq_norms=torch.cat([g_a.sq_norms, g_b.sq_norms]),
        row_scale=torch.cat([g_a.row_scale, g_b.row_scale]),
    )


def _chunked_cross_search(g, xg, queries, draws, scfg, chunk: int, coarse=None):
    """Search ``queries`` against sub-graph ``g`` (over ``xg``) in chunks of
    ``chunk`` rows, the last one padded with zero rows; chunk i draws its
    entry points from ``draws.fold_in(i)``.  Returns (ids (B, k) local to
    g, dists (B, k), comps of every lane, padding included, as an int)."""
    from repro_torch.core import search as search_lib  # search never imports merge

    if coarse is None and scfg.seed_mode == "coarse":
        # no level for this sub-graph's id space: random seeds
        scfg = dataclasses.replace(scfg, seed_mode="random")
    n_landmarks = coarse.n_landmarks if scfg.seed_mode == "coarse" else None
    B = queries.shape[0]
    nchunks = -(-B // chunk)
    qp = torch.cat([queries, queries.new_zeros((nchunks * chunk - B, queries.shape[1]))])
    ids, dists = [], []
    comps = torch.zeros((), dtype=torch.int64, device=queries.device)
    for i in range(nchunks):
        entry = search_entry(draws.fold_in(i), chunk, scfg.n_seeds, g.n_valid, n_landmarks,
                             queries.device)
        seeds, coarse_seeds = entry if isinstance(entry, tuple) else (entry, None)
        res = search_lib.search(g, xg, qp[i * chunk:(i + 1) * chunk], scfg, seeds=seeds,
                                coarse=coarse, coarse_seeds=coarse_seeds, device=queries.device)
        ids.append(res.ids)
        dists.append(res.dists)
        comps = comps + res.n_comps.sum()
    return torch.cat(ids)[:B], torch.cat(dists)[:B], int(comps)


def merge_commit_core(g_a, g_b, xa, xb, ab_ids, ab_d, ba_ids, ba_d, metric: str):
    """Stack, second-hop proposals, candidate commit and reverse rebuild.

    ``ab_ids``/``ab_d`` (n_a, k) are a's rows searched in g_b (b-local
    ids), ``ba_ids``/``ba_d`` (n_b, k) b's rows searched in g_a.  Each
    direction also proposes its hits' own lists (``ops.merge_proposals``),
    pre-selected to the best 2k per row; every pair enters in both
    directions, and a dead row neither receives nor donates an edge.
    Returns (merged graph, comps of the proposals as an int)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels import ops

    n_a = xa.shape[0]
    dev = g_a.nbr_ids.device
    stacked = _stack_core(g_a, g_b)
    ab_hop, ab_hop_d, c_ab = ops.merge_proposals(
        xa, xb, ab_ids, g_b.nbr_ids, g_b.alive, metric, sq_norms=g_b.sq_norms, hop_top=HOP_TOP)
    ba_hop, ba_hop_d, c_ba = ops.merge_proposals(
        xb, xa, ba_ids, g_a.nbr_ids, g_a.alive, metric, sq_norms=g_a.sq_norms, hop_top=HOP_TOP)
    # of the h·k_t hop lanes of a row only the best 2k can matter
    k = g_a.k
    if ab_hop.shape[1] > 2 * k:
        ab_hop_d, ab_hop = ops.topk_smallest(ab_hop_d, ab_hop, 2 * k)
        ba_hop_d, ba_hop = ops.topk_smallest(ba_hop_d, ba_hop, 2 * k)

    def rows_for(lo, live, like):
        r = (torch.arange(like.shape[0], dtype=torch.int32, device=dev) + lo)[:, None]
        return torch.where(live[:, None], r, -1).expand(like.shape)

    def to_global_b(ids):
        return torch.where(ids >= 0, ids + n_a, -1)

    families = (  # (query rows, candidate ids global, distances)
        (rows_for(0, g_a.alive, ab_ids), to_global_b(ab_ids), ab_d),
        (rows_for(n_a, g_b.alive, ba_ids), ba_ids, ba_d),
        (rows_for(0, g_a.alive, ab_hop), to_global_b(ab_hop), ab_hop_d),
        (rows_for(n_a, g_b.alive, ba_hop), ba_hop, ba_hop_d),
    )
    rows = [r.reshape(-1) for r, _, _ in families]
    cands = [c.reshape(-1) for _, c, _ in families]
    v = torch.cat(rows + cands)
    q = torch.cat(cands + rows)
    d = torch.cat([dd.reshape(-1) for _, _, dd in families] * 2)
    v = torch.where((q >= 0) & (v >= 0), v, -1)  # a pair with a masked end is dropped
    mres = merge_candidates(stacked.nbr_ids, stacked.nbr_dist, stacked.nbr_lam, v, q, d)
    merged = stacked._replace(nbr_ids=mres.nbr_ids, nbr_dist=mres.nbr_dist, nbr_lam=mres.nbr_lam)
    return graph_lib.rebuild_reverse(merged), int(c_ab + c_ba)


def symmetric_merge(g_a, g_b, x: torch.Tensor, scfg, draws=None, *, search_chunk: int = 512,
                    coarse_a=None, coarse_b=None):
    """Merge two independently built sub-graphs into one graph (1908.00814).

    ``g_a`` covers rows [0, n_a) of ``x``, ``g_b`` the rest in local ids;
    both must be fully allocated.  Each side's rows search the other side's
    graph (``scfg``, in chunks of ``search_chunk``; ``coarse_a``/``coarse_b``
    seed a side's searches from its coarse level in its local ids), the
    hits and their second-hop lists are committed in both directions, and
    the reverse lists are rebuilt.  Dead rows neither search nor receive
    edges.  ``draws`` (a ``core.draws.Draws``, default ``TorchDraws(0)``)
    is split between the sides' searches.

    Returns (merged graph, comps of the cross searches and the proposals)."""
    n_a, n_b = g_a.capacity, g_b.capacity
    if x.shape[0] != n_a + n_b:
        raise ValueError(f"x has {x.shape[0]} rows, graphs cover {n_a + n_b}")
    _check_allocated(g_a, g_b, "symmetric_merge")  # before the searches
    draws = TorchDraws(0) if draws is None else draws
    xa, xb = x[:n_a], x[n_a:]
    d_a, d_b = draws.split()
    ab_ids, ab_d, comps_a = _chunked_cross_search(g_b, xb, xa, d_a, scfg, search_chunk, coarse_b)
    ba_ids, ba_d, comps_b = _chunked_cross_search(g_a, xa, xb, d_b, scfg, search_chunk, coarse_a)
    merged, hop_comps = merge_commit_core(g_a, g_b, xa, xb, ab_ids, ab_d, ba_ids, ba_d,
                                          scfg.metric)
    return merged, comps_a + comps_b + hop_comps


def _pairs_mesh_ready(pairs, mesh) -> bool:
    """A level merges on the group iff its pairs are no more than the ranks
    and every pair has the same shapes (the reference's test)."""
    from repro_torch.core import distributed  # late: distributed imports merge

    if mesh is None or len(pairs) > distributed.world_size(mesh):
        return False

    def sig(node):
        g = node[0]
        return (g.capacity, g.k, g.rev_capacity)

    a0, b0 = sig(pairs[0][0]), sig(pairs[0][1])
    return all(sig(a) == a0 and sig(b) == b0 for a, b in pairs)


def merge_subgraphs(graphs, x: torch.Tensor, scfg, draws=None, *, search_chunk: int = 512,
                    coarses=None, mesh=None, tracker=None):
    """Fold S adjacent sub-graphs into one with a balanced pairwise tree of
    ``symmetric_merge`` calls: O(log S) cross searches per row.

    ``graphs[s]`` covers, in local ids, the s-th contiguous block of ``x``
    (block sizes are the capacities).  An odd node at a level is carried to
    the next.  ``coarses`` (aligned with ``graphs``, entries may be None)
    seed the level-0 cross searches; each merged pair gets a folded level
    (``hierarchy.fold_coarse``) that seeds the next level's.  ``tracker``
    (an ``obs.Tracker``) times each level under ``merge/level<l>`` and the
    folds under ``merge/fold``.

    ``mesh`` (a ``torch.distributed`` process group; every rank calls with
    the same arguments): a level whose pairs are no more than the ranks and
    share their shapes merges one pair per rank
    (``distributed.merge_pairs_mesh``, coarse-seeded only when every pair
    has both levels, each side's cross search one batch, as the
    reference's); other levels merge here one after another, their cross
    searches in chunks of ``search_chunk``.  Every rank returns the same
    graph.

    Returns (merged graph over all of x, comps of every merge and fold, the
    root coarse level or None)."""
    from repro_torch.core import hierarchy  # late: hierarchy imports merge
    from repro_torch.obs import NOOP

    if not graphs:
        raise ValueError("merge_subgraphs needs at least one sub-graph")
    if coarses is not None and len(coarses) != len(graphs):
        raise ValueError(f"coarses has {len(coarses)} entries for {len(graphs)} sub-graphs")
    if sum(g.capacity for g in graphs) != x.shape[0]:
        raise ValueError(
            f"sub-graphs cover {sum(g.capacity for g in graphs)} rows, x has {x.shape[0]}")
    draws = TorchDraws(0) if draws is None else draws
    trk = tracker if tracker is not None else NOOP
    # (graph, lo, hi, coarse): graph covers x[lo:hi] in its local ids
    nodes, off = [], 0
    for s, g in enumerate(graphs):
        nodes.append((g, off, off + g.capacity, coarses[s] if coarses else None))
        off += g.capacity
    total_comps, level = 0, 0
    while len(nodes) > 1:
        pairs = [(nodes[i], nodes[i + 1]) for i in range(0, len(nodes) - 1, 2)]
        carry = [nodes[-1]] if len(nodes) % 2 else []
        pair_draws = [draws.fold_in((level << 16) | i) for i in range(len(pairs))]
        out = []
        with trk.span(f"merge/level{level}") as sp:
            if _pairs_mesh_ready(pairs, mesh):
                from repro_torch.core import distributed  # late: distributed imports merge

                pair_coarses = [(a[3], b[3]) for a, b in pairs]
                if any(ca is None or cb is None for ca, cb in pair_coarses):
                    pair_coarses = None
                merged, c = distributed.merge_pairs_mesh(
                    mesh, [(a[0], b[0]) for a, b in pairs], [x[a[1]:b[2]] for a, b in pairs],
                    scfg, pair_draws, coarses=pair_coarses)
                total_comps += c
                out = [[g, a[1], b[2], None] for g, (a, b) in zip(merged, pairs)]
            else:
                for i, ((ga, lo, mid, ca), (gb, _, hi, cb)) in enumerate(pairs):
                    g, c = symmetric_merge(ga, gb, x[lo:hi], scfg, pair_draws[i],
                                           search_chunk=search_chunk, coarse_a=ca, coarse_b=cb)
                    total_comps += c
                    out.append([g, lo, hi, None])
            sp.sync(out[-1][0].nbr_ids)
        with trk.span("merge/fold") as sp:
            for i, ((_, lo, mid, ca), (_, _, _, cb)) in enumerate(pairs):
                lvl, c = hierarchy.fold_coarse(ca, cb, mid - lo, scfg, pair_draws[i].fold_in(7))
                total_comps += c
                out[i][3] = lvl
            sp.sync(None if out[-1][3] is None else out[-1][3].graph.nbr_ids)
        nodes = [tuple(o) for o in out] + carry
        level += 1
    return nodes[0][0], total_comps, nodes[0][3]
