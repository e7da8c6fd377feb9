"""Online k-NN graph construction — OLG (Alg. 2) and LGD (Alg. 3) in waves
(counterpart of the sequential build in ``repro.core.construct``).

The build inserts waves of W rows: the whole wave searches the frozen graph
(``core.search``), an intra-wave W x W distance tile lets rows of one wave
find each other, and one batched commit (``commit_wave``) writes the new
rows, merges the candidate edges the searches logged into existing rows,
updates the LGD occlusion factors λ (Rules 2/3) from distances the searches
already computed, and appends the reverse lists.  W = 1 is the paper's
sequential algorithm; ``lgd=False`` gives OLG.  ``precision`` picks the
searches' distance engine (fp32, bf16, int8 or PQ rank-then-rerank).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import brute, merge
from repro_torch.core import search as search_lib
from repro_torch.core.counters import counter
from repro_torch.core.graph import KNNGraph, row_scales, squared_norms
from repro_torch.core.search import SearchConfig
from repro_torch.kernels import expand as expand_lib
from repro_torch.kernels import ops, ref
from repro_torch.kernels import precision as precision_lib

# seed_fn(wave, pos, W, n_valid) -> (W, n_seeds) int entry points of a wave
SeedFn = Callable[[int, int, int, int], torch.Tensor]

# probe depth of the commit's D(q, x_j) lookups (the reference fixes it)
_LOOKUP_PROBES = 8


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    k: int = 20  # graph degree
    metric: str = "l2"
    n_seed_init: int = 256  # |I|, fixed to 256 across the paper
    wave: int = 256  # W — rows inserted per batched round
    lgd: bool = True  # Alg. 3 (True) vs Alg. 2 / OLG (False)
    rev_cap: Optional[int] = None  # reverse ring capacity (default 2k)
    ins_cap_per_q: Optional[int] = None  # rows one query may update (default 3k)
    beam: int = 40
    n_seeds: int = 8  # p
    hash_slots: Optional[int] = None  # None = auto-size from beam/max_iters
    max_iters: int = 60
    # distance-engine precision of the insertion searches; the intra-wave
    # tile of the commit stays fp32
    precision: str = "fp32"  # "fp32" | "bf16" | "int8" | "pq"
    rerank_factor: int = 4  # pq: exact re-rank width = rerank_factor * k

    def __post_init__(self):
        precision_lib.validate_precision(self.precision)

    def search_config(self) -> SearchConfig:
        return SearchConfig(
            k=self.k,
            beam=max(self.beam, self.k),
            n_seeds=self.n_seeds,
            hash_slots=self.hash_slots,
            max_iters=self.max_iters,
            metric=self.metric,
            use_lgd_mask=self.lgd,
            precision=self.precision,
            rerank_factor=self.rerank_factor,
        )


class BuildStats(NamedTuple):
    """Build counters: 0-d int64 tensors on the build's device."""

    n_comps: torch.Tensor  # distance computations (Eq. 2 numerator)
    n_waves: int
    n_inserted_edges: torch.Tensor


def scanning_rate(stats: BuildStats, n: int) -> float:
    """Eq. 2: c = C / (n (n-1) / 2)."""
    return int(stats.n_comps) / (n * (n - 1) / 2.0)


def _lookup_D(vis_ids, vis_dist, lane, ids, probes: int) -> torch.Tensor:
    """D(q_lane, ids): the distance if the lane's search computed it, else
    +inf (Rule 1/3).  ids (T, k) -> (T, k)."""
    H = vis_ids.shape[1]
    slots = expand_lib.probe_slots(ids, H, probes)  # (T, k, P)
    li = lane.long()[:, None, None]
    hit = vis_ids[li, slots] == ids[..., None]
    return torch.where(hit, vis_dist[li, slots], float("inf")).amin(dim=-1)


def commit_wave(
    g: KNNGraph,
    x: torch.Tensor,
    q_start: int,
    n_real: int,
    res: search_lib.SearchResult,
    cfg: BuildConfig,
) -> tuple[KNNGraph, torch.Tensor]:
    """Apply one wave's search results to the graph; wave rows are
    [q_start, q_start + W), the first ``n_real`` of them real.  Returns
    (graph, edges inserted into existing rows)."""
    W = res.ids.shape[0]
    cap, k = g.nbr_ids.shape
    dev = g.nbr_ids.device
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    q_ids = q_start + lanes
    q_mask = lanes < n_real
    xq = x[q_ids.clamp_max(cap - 1).long()]
    # wave-row caches, computed once: the l2 tile reuses the norms
    xq_sq = squared_norms(xq)
    xq_sc = row_scales(xq)

    # ---- 1. new-row lists: search results ‖ intra-wave candidates ----------
    new_ids, new_dist = res.ids, res.dists
    intra = W > 1  # wave rows see each other through the W x W tile
    if intra:
        tile = ops.pairwise_distance(
            xq, xq, cfg.metric, x_sq_norms=xq_sq if cfg.metric == "l2" else None
        )
        off = ~(q_mask[None, :] & q_mask[:, None]) | torch.eye(W, dtype=torch.bool, device=dev)
        tile = torch.where(off, float("inf"), tile)
        cat_d = torch.cat([new_dist, tile], dim=1)
        cat_i = torch.cat([new_ids, q_ids[None, :].expand(W, W)], dim=1)
        new_dist, new_ids = ref.topk_smallest(cat_d, cat_i, k)
    new_ids = torch.where(torch.isfinite(new_dist), new_ids, -1)
    new_dist = torch.where(new_ids >= 0, new_dist, float("inf"))

    # ---- 2. candidate edges into existing rows ------------------------------
    ins_cap = cfg.ins_cap_per_q or 3 * k
    v_all, d_all = res.vis_ids, res.vis_dist  # (W, H)
    kth = g.nbr_dist[v_all.clamp_min(0).long(), k - 1]
    qual = (v_all >= 0) & q_mask[:, None] & (d_all < kth)
    keyed = torch.where(qual, d_all, float("inf"))
    order = torch.argsort(keyed, dim=1, stable=True)[:, :ins_cap]
    v_kept = torch.gather(torch.where(qual, v_all, -1), 1, order)
    d_kept = torch.gather(keyed, 1, order)
    kept = v_kept.shape[1]
    v_flat = v_kept.reshape(-1)
    d_flat = d_kept.reshape(-1)
    q_flat = q_ids[:, None].expand(W, kept).reshape(-1)
    lane_flat = lanes[:, None].expand(W, kept).reshape(-1)

    mres = merge.merge_candidates(g.nbr_ids, g.nbr_dist, g.nbr_lam, v_flat, q_flat, d_flat)
    m_ids, m_dist, m_lam = mres.nbr_ids, mres.nbr_dist, mres.nbr_lam

    # ---- 3. LGD occlusion-factor rules (Alg. 3 / updateG) -------------------
    safe_v = v_flat.clamp(0, cap - 1).long()
    row_ids = m_ids[safe_v]  # (T, k) merged list of each target row
    at_q = row_ids == q_flat[:, None]
    inserted = at_q.any(dim=1) & (v_flat >= 0)
    lam_q = None
    if cfg.lgd:
        j_star = torch.argmax(at_q.to(torch.uint8), dim=1)  # q's slot in the row
        # D(q, member_j): wave-wave pairs from the intra tile, others from the
        # visited hash (+inf when the search never compared them — Rule 1)
        is_wave = (row_ids >= q_start) & (row_ids < q_start + W)
        D_hash = _lookup_D(res.vis_ids, res.vis_dist, lane_flat, row_ids, _LOOKUP_PROBES)
        if intra:
            w_idx = (row_ids - q_start).clamp(0, W - 1).long()
            D = torch.where(is_wave, tile[lane_flat.long()[:, None], w_idx], D_hash)
        else:
            D = torch.where(is_wave, float("inf"), D_hash)
        occludes = (D < d_flat[:, None]) & (row_ids >= 0) & inserted[:, None]
        slots_k = torch.arange(k, device=dev)[None, :]
        before = slots_k < j_star[:, None]
        after = slots_k > j_star[:, None]
        # Rule 2: λ(q) = #{j ranked before q : D(q, x_j) < m(q, v)}
        lam_q = (occludes & before).sum(dim=1).to(torch.int32)
        ins_rows = safe_v[inserted]
        m_lam.index_put_((ins_rows, j_star[inserted]), lam_q[inserted], accumulate=True)
        # Rule 3: λ(x_j) += 1 for j ranked after q with D(q, x_j) < m(q, v)
        add3 = (occludes & after).to(torch.int32)[inserted]
        m_lam.index_put_(
            (ins_rows[:, None].expand_as(add3), slots_k.expand_as(add3)), add3,
            accumulate=True,
        )

    # ---- 4. write back: existing-row merges + new rows ----------------------
    # padding lanes are dropped, never clamped onto the real last row; the
    # merge's outputs are fresh tensors, written in place, the input graph's
    # caches are copied first
    real = q_ids[q_mask].long()
    nbr_ids, nbr_dist, nbr_lam = m_ids, m_dist, m_lam
    nbr_ids[real] = new_ids[q_mask]
    nbr_dist[real] = new_dist[q_mask]
    nbr_lam[real] = 0  # λ starts at 0 on join (Alg. 3)
    sq_norms, row_scale, alive = g.sq_norms.clone(), g.row_scale.clone(), g.alive.clone()
    sq_norms[real] = xq_sq[q_mask]
    row_scale[real] = xq_sc[q_mask]
    alive[real] = True

    # ---- 5. reverse-list appends --------------------------------------------
    # (a) new rows list their members; (b) inserted queries join target rows.
    # rev_lam snapshots the forward twin's λ: 0 for (a), Rule-2 λ(q) for (b).
    own_a = q_ids[:, None].expand(W, k).reshape(-1)
    mem_a = torch.where(q_mask[:, None], new_ids, -1).reshape(-1)
    own_b = torch.where(inserted, v_flat, -1)
    mem_b = torch.where(inserted, q_flat, -1)
    lam_b = torch.where(inserted, lam_q, 0) if cfg.lgd else torch.zeros_like(own_b)
    rev_ids, rev_lam, rev_ptr = merge.append_reverse(
        g.rev_ids, g.rev_lam, g.rev_ptr,
        torch.cat([own_a, own_b]), torch.cat([mem_a, mem_b]),
        torch.cat([torch.zeros_like(own_a), lam_b]),
    )
    g2 = KNNGraph(
        nbr_ids=nbr_ids,
        nbr_dist=nbr_dist,
        nbr_lam=nbr_lam,
        rev_ids=rev_ids,
        rev_lam=rev_lam,
        rev_ptr=rev_ptr,
        alive=alive,
        n_valid=min(g.n_valid + n_real, cap),
        sq_norms=sq_norms,
        row_scale=row_scale,
    )
    return g2, mres.n_inserted


def wave_core(
    g: KNNGraph,
    x: torch.Tensor,
    pos: int,
    seeds: torch.Tensor,
    stats: BuildStats,
    cfg: BuildConfig,
    enc: Optional[precision_lib.EncodedData] = None,
) -> tuple[KNNGraph, BuildStats]:
    """One wave: rows [pos, pos + W) search the graph from ``seeds`` (W, p)
    and are committed; the stats fold in the wave's comparisons.  ``enc``
    is the compressed table of the whole of ``x`` (``cfg.precision``)."""
    W = cfg.wave
    n = x.shape[0]
    n_real = min(W, n - pos)
    lanes = torch.arange(W, device=x.device)
    q = x[(pos + lanes).clamp_max(n - 1)]
    res = search_lib.search(
        g, x, q, cfg.search_config(), seeds=seeds, enc=enc, device=x.device
    )
    res = res._replace(n_comps=torch.where(lanes < n_real, res.n_comps, 0))
    g2, edges = commit_wave(g, x, pos, n_real, res, cfg)
    comps = res.n_comps.sum()
    if W > 1:  # the intra-wave tile's pairs
        comps = comps + n_real * (n_real - 1) // 2
    return g2, BuildStats(
        n_comps=stats.n_comps + comps,
        n_waves=stats.n_waves + 1,
        n_inserted_edges=stats.n_inserted_edges + edges,
    )


def build(
    x: torch.Tensor,
    cfg: BuildConfig,
    *,
    generator: Optional[torch.Generator] = None,
    seed_fn: Optional[SeedFn] = None,
    device=None,
) -> tuple[KNNGraph, BuildStats]:
    """Build the k-NN graph over x (n, d) with OLG (``cfg.lgd=False``) or LGD.

    The exact seed graph covers the first ``n_seed_init`` rows; then each
    wave's entry points come from ``seed_fn(wave, pos, W, n_valid)`` when
    given (replayed or injected seeds), else from ``generator`` (uniform
    over the committed rows).  ``device``: where to run (None: the card,
    raising without one).
    """
    dev = device_lib.resolve(device)
    x = x.to(dev).float()
    n = x.shape[0]
    # one encode of the whole dataset serves every wave: rows not yet
    # inserted are never candidates, so encoding them early changes nothing
    enc = precision_lib.encode_dataset(x, cfg.precision)
    n_seed = min(cfg.n_seed_init, n)
    g = brute.exact_seed_graph(
        x, n_seed, cfg.k, cfg.metric, rev_capacity=cfg.rev_cap, device=dev
    )
    stats = BuildStats(
        n_comps=counter(n_seed * (n_seed - 1) // 2, dev),  # seed-graph comps
        n_waves=0,
        n_inserted_edges=counter(0, dev),
    )
    W = cfg.wave
    pos = n_seed
    while pos < n:
        if seed_fn is not None:
            seeds = torch.as_tensor(seed_fn(stats.n_waves, pos, W, g.n_valid))
        else:
            seeds = search_lib.random_seeds(W, cfg.n_seeds, g.n_valid, generator, dev)
        g, stats = wave_core(g, x, pos, seeds.to(dev), stats, cfg, enc)
        pos += min(W, n - pos)
    return g, stats
