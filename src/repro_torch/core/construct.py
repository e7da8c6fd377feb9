"""Online k-NN graph construction — OLG (Alg. 2) and LGD (Alg. 3) in waves
(counterpart of the sequential build in ``repro.core.construct``).

The build inserts waves of W rows: the whole wave searches the frozen graph
(``core.search``), an intra-wave W x W distance tile lets rows of one wave
find each other, and one batched commit (``commit_wave``) writes the new
rows, merges the candidate edges the searches logged into existing rows,
updates the LGD occlusion factors λ (Rules 2/3) from distances the searches
already computed, and appends the reverse lists.  W = 1 is the paper's
sequential algorithm; ``lgd=False`` gives OLG.  ``precision`` picks the
searches' distance engine (fp32, bf16, int8 or PQ rank-then-rerank);
``seed_mode="coarse"`` seeds the insertion searches from a coarse landmark
level (``core.hierarchy``) that the waves keep up to date.  ``build`` also
resumes from a graph (``initial``), which is how ``core.dynamic.insert``
adds rows online.

``build_parallel`` is the divide-and-conquer build: contiguous blocks
built one after another on the one device, folded by a balanced tree of
symmetric merges (``merge.merge_subgraphs``) and refined by NN-Descent
join rounds (``nndescent.refine``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import device as device_lib
from repro_torch.core import brute, merge, nndescent
from repro_torch.core import draws as draws_lib
from repro_torch.core import search as search_lib
from repro_torch.core.counters import counter
from repro_torch.core.graph import KNNGraph, row_scales, squared_norms
from repro_torch.core.search import SearchConfig
from repro_torch.kernels import expand as expand_lib
from repro_torch.kernels import ops, ref
from repro_torch.kernels import precision as precision_lib

# seed_fn(wave, pos, W, n_valid) -> the (W, n_seeds) int entry points of a
# wave, or under coarse seeding the pair (seeds, (W, n_seeds) entry points of
# the coarse pass over the landmarks)
SeedFn = Callable[[int, int, int, int], Union[torch.Tensor, tuple]]

# probe depth of the commit's D(q, x_j) lookups (the reference fixes it)
_LOOKUP_PROBES = 8


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    k: int = 20  # graph degree
    metric: str = "l2"
    n_seed_init: int = 256  # |I|, fixed to 256 across the paper
    wave: int = 256  # W — rows inserted per batched round
    lgd: bool = True  # Alg. 3 (True) vs Alg. 2 / OLG (False)
    intra_wave: bool = True  # wave rows see each other (the W x W tile)
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
    data_bf16: bool = False  # store the dataset bf16 (distances accumulate fp32)
    # hierarchical entry-point seeding (core.hierarchy)
    seed_mode: str = "random"  # "random" | "coarse"
    coarse_landmarks: Optional[int] = None  # L; None = ~4·√n
    coarse_members: int = 8  # M — member-cell ring capacity per landmark
    coarse_top: int = 4  # T winning landmarks seeding each fine search

    def __post_init__(self):
        precision_lib.validate_precision(self.precision)
        if self.seed_mode not in ("random", "coarse"):
            raise ValueError(f"seed_mode must be 'random' or 'coarse', got {self.seed_mode!r}")

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
            seed_mode=self.seed_mode,
            coarse_top=self.coarse_top,
        )


class BuildStats(NamedTuple):
    """Build counters: 0-d int64 tensors on the build's device."""

    n_comps: torch.Tensor  # distance computations (Eq. 2 numerator)
    n_waves: int
    n_inserted_edges: torch.Tensor


def zero_stats(n_comps: int = 0, device=None) -> BuildStats:
    """Fresh counters, optionally pre-charged with ``n_comps``."""
    return BuildStats(n_comps=counter(n_comps, device), n_waves=0,
                      n_inserted_edges=counter(0, device))


def scanning_rate(stats: BuildStats, n: int) -> float:
    """Eq. 2: c = C / (n (n-1) / 2)."""
    return int(stats.n_comps) / (n * (n - 1) / 2.0)


def stored_data(x: torch.Tensor, cfg: BuildConfig, device) -> torch.Tensor:
    """The dataset as a build holds it on ``device``: bfloat16 under
    ``cfg.data_bf16`` or when given bf16 (the reference keeps the dtype it
    is given, and its configs pair the flag with bf16 rows), else float32.
    Every distance over bf16 rows widens them and accumulates in fp32."""
    bf16 = cfg.data_bf16 or x.dtype == torch.bfloat16
    return x.to(device=device, dtype=torch.bfloat16 if bf16 else torch.float32)


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
    # padding lanes read the last row of x (cap exceeds x's rows on insert)
    xq = x[q_ids.clamp_max(min(cap, x.shape[0]) - 1).long()]
    # wave-row caches, computed once: the l2 tile reuses the norms
    xq_sq = squared_norms(xq)
    xq_sc = row_scales(xq)

    # ---- 1. new-row lists: search results ‖ intra-wave candidates ----------
    new_ids, new_dist = res.ids, res.dists
    intra = cfg.intra_wave and W > 1  # wave rows see each other through the W x W tile
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
        # the λ updates add over whole tensors: an edge that was not inserted
        # adds 0, at a row of its own lane (spread, so the zeros contend for
        # no one atomic), so no shape depends on the data and the integer sums
        # are those of the inserted edges alone
        ins_rows = torch.where(inserted, safe_v, lane_flat.long() % cap)
        m_lam.index_put_((ins_rows, j_star), torch.where(inserted, lam_q, 0), accumulate=True)
        # Rule 3: λ(x_j) += 1 for j ranked after q with D(q, x_j) < m(q, v)
        add3 = (occludes & after & inserted[:, None]).to(torch.int32)
        m_lam.index_put_(
            (ins_rows[:, None].expand_as(add3), slots_k.expand_as(add3)), add3,
            accumulate=True,
        )

    # ---- 4. write back: existing-row merges + new rows ----------------------
    # padding lanes are dropped, never clamped onto the real last row; the
    # merge's outputs are fresh tensors, written in place, the input graph's
    # caches are copied first
    # the real lanes are the first n_real, rows [q_start, q_start + n_real)
    real = q_ids[:n_real].long()
    nbr_ids, nbr_dist, nbr_lam = m_ids, m_dist, m_lam
    nbr_ids[real] = new_ids[:n_real]
    nbr_dist[real] = new_dist[:n_real]
    nbr_lam[real] = 0  # λ starts at 0 on join (Alg. 3)
    sq_norms, row_scale, alive = g.sq_norms.clone(), g.row_scale.clone(), g.alive.clone()
    sq_norms[real] = xq_sq[:n_real]
    row_scale[real] = xq_sc[:n_real]
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
    *,
    coarse: Any = None,
    coarse_seeds: Optional[torch.Tensor] = None,
    n_real: Optional[int] = None,
):
    """One wave: rows [pos, pos + W) search the graph from ``seeds`` (W, p)
    and are committed; the stats fold in the wave's comparisons.  ``enc``
    is the compressed table of the whole of ``x`` (``cfg.precision``).
    ``n_real`` (default ``min(W, n - pos)``) is how many of the W rows are
    real; the distributed step passes its shard-local count.

    With a ``coarse`` level (a ``core.hierarchy.CoarseLevel``) the searches
    seed coarsely from ``coarse_seeds`` and each committed row joins its
    winning landmark's cell.  Without one, ``seed_mode="coarse"`` seeds
    randomly for this wave.  Returns (graph, stats, coarse), coarse None
    when none was given."""
    W = cfg.wave
    if n_real is None:
        n_real = min(W, x.shape[0] - pos)
    q = wave_queries(x, pos, W)
    scfg = cfg.search_config()
    if coarse is None and scfg.seed_mode == "coarse":
        scfg = dataclasses.replace(scfg, seed_mode="random")
    res = search_lib.search(
        g, x, q, scfg, seeds=seeds, enc=enc, coarse=coarse, coarse_seeds=coarse_seeds,
        device=x.device,
    )
    g2, stats2, res = finish_wave(g, x, pos, n_real, res, stats, cfg)
    if coarse is None:
        return g2, stats2, None
    from repro_torch.core import hierarchy  # late: hierarchy imports construct

    lanes = torch.arange(W, device=x.device)
    rows = torch.where(lanes < n_real, pos + lanes, -1).to(torch.int32)
    return g2, stats2, hierarchy.note_inserted(coarse, rows, res.seed_cell)


def wave_queries(x: torch.Tensor, pos: int, W: int) -> torch.Tensor:
    """The (W, d) query rows of the wave at ``pos``; lanes past the last
    row of ``x`` repeat it."""
    lanes = torch.arange(W, device=x.device)
    return x[(pos + lanes).clamp_max(x.shape[0] - 1)]


def finish_wave(g: KNNGraph, x: torch.Tensor, pos: int, n_real: int,
                res: search_lib.SearchResult, stats: BuildStats, cfg: BuildConfig):
    """A wave after its searches: the padding lanes' comparisons dropped,
    the wave committed, its comparisons (the intra-wave tile's pairs too)
    and inserted edges folded into ``stats``.  Returns (graph, stats, the
    result as charged)."""
    W = res.ids.shape[0]
    lanes = torch.arange(W, device=x.device)
    res = res._replace(n_comps=torch.where(lanes < n_real, res.n_comps, 0))
    g2, edges = commit_wave(g, x, pos, n_real, res, cfg)
    comps = res.n_comps.sum()
    if cfg.intra_wave and W > 1:  # the intra-wave tile's pairs
        comps = comps + n_real * (n_real - 1) // 2
    stats2 = BuildStats(
        n_comps=stats.n_comps + comps,
        n_waves=stats.n_waves + 1,
        n_inserted_edges=stats.n_inserted_edges + edges,
    )
    return g2, stats2, res


def build(
    x: torch.Tensor,
    cfg: BuildConfig,
    *,
    generator: Optional[torch.Generator] = None,
    seed_fn: Optional[SeedFn] = None,
    wave_callback: Optional[Callable[[int, KNNGraph], None]] = None,
    callback_stride: int = 1,
    initial: Optional[tuple[KNNGraph, int]] = None,
    coarse: Any = None,
    return_coarse: bool = False,
    landmark_rows: Optional[torch.Tensor] = None,
    landmark_seed_fn: Optional[SeedFn] = None,
    tracker=None,
    device=None,
):
    """Build the k-NN graph over x (n, d) with OLG (``cfg.lgd=False``) or LGD.

    The exact seed graph covers the first ``n_seed_init`` rows; then each
    wave's entry points come from ``seed_fn(wave, pos, W, n_valid)`` when
    given (replayed or injected seeds; under coarse seeding it may return
    ``(seeds, coarse_seeds)``), else from ``generator`` (uniform over the
    committed rows, and over the landmarks for the coarse pass).

    ``initial=(graph, next_row)`` resumes instead: no seed graph and no
    pre-charge, waves from ``next_row``; the caller's graph is left
    untouched.  Under ``seed_mode="coarse"`` without a ``coarse`` level, one
    is bootstrapped before the first wave: over the whole of ``x`` with its
    comparisons charged (``hierarchy.build_coarse``) from scratch, or
    derived from the resumed graph, uncharged (``hierarchy.derive_coarse``).
    ``landmark_rows`` and ``landmark_seed_fn`` inject that level's landmarks
    and the entry points of its landmark-graph build.

    ``wave_callback(n_waves, graph)`` runs every ``callback_stride`` waves.
    ``tracker`` (an ``obs.Tracker``) times each stride under a
    ``build/stride`` span synced on the graph and logs the cumulative
    counters there; without one nothing is timed or synced.  ``device``:
    where to run (None: the card, raising without one).

    Returns (graph, stats), plus the coarse level when ``return_coarse``.
    """
    from repro_torch.core import hierarchy  # late: hierarchy imports construct
    from repro_torch.obs import NOOP

    if callback_stride < 1:
        raise ValueError(f"callback_stride must be >= 1, got {callback_stride}")
    dev = device_lib.resolve(device)
    x = stored_data(x, cfg, dev)
    n = x.shape[0]
    # one encode of the whole dataset serves every wave: rows not yet
    # inserted are never candidates, so encoding them early changes nothing
    enc = precision_lib.encode_dataset(x, cfg.precision)
    coarse_kw = dict(landmark_rows=landmark_rows, seed_fn=landmark_seed_fn,
                     generator=generator, device=dev)
    if initial is not None:
        g, start = initial
        g = g.to(dev)
        if coarse is None and cfg.seed_mode == "coarse" and start > 0:
            coarse = hierarchy.derive_coarse(g, x, cfg, **coarse_kw)
        pre_charge = 0
    else:
        n_seed = min(cfg.n_seed_init, n)
        g = brute.exact_seed_graph(
            x, n_seed, cfg.k, cfg.metric, rev_capacity=cfg.rev_cap, device=dev
        )
        start = n_seed
        pre_charge = n_seed * (n_seed - 1) // 2  # seed-graph comps
        if coarse is None and cfg.seed_mode == "coarse":
            coarse, coarse_comps = hierarchy.build_coarse(
                x, cfg, assign_rows=torch.arange(n_seed, dtype=torch.int32, device=dev),
                **coarse_kw,
            )
            pre_charge += coarse_comps
    if coarse is not None:
        coarse = coarse.to(dev)
    stats = zero_stats(pre_charge, dev)
    trk = tracker if tracker is not None else NOOP
    W = cfg.wave
    pos = start
    while pos < n:
        with trk.span("build/stride") as sp:
            stride_end = stats.n_waves + callback_stride
            while pos < n and stats.n_waves < stride_end:
                seeds, coarse_seeds = _wave_seeds(
                    seed_fn, generator, stats.n_waves, pos, W, g.n_valid, cfg, coarse, dev
                )
                g, stats, coarse = wave_core(g, x, pos, seeds, stats, cfg, enc,
                                             coarse=coarse, coarse_seeds=coarse_seeds)
                pos += min(W, n - pos)
            sp.sync(g.nbr_ids)
        if wave_callback is not None and stats.n_waves % callback_stride == 0:
            wave_callback(stats.n_waves, g)
        if tracker is not None:
            comps = int(stats.n_comps)
            trk.log_metrics(
                {
                    "build/rows_inserted": pos,
                    "build/n_comps": comps,
                    "build/n_inserted_edges": int(stats.n_inserted_edges),
                    "build/scanning_rate_partial": comps / (n * (n - 1) / 2.0) if n > 1 else 0.0,
                },
                step=stats.n_waves,
            )
    if return_coarse:
        return g, stats, coarse
    return g, stats


def _sub_builds(x, cfg, draws, bounds, dev):
    """``build`` of each block [bounds[s], bounds[s + 1]) of x, one after
    another, block s drawing from ``draws.fold_in(s)``: (graphs, coarse
    levels, comps, waves, edges)."""
    graphs, coarses = [], []
    comps = waves = edges = 0
    for s in range(len(bounds) - 1):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        g, st, c = build(x[lo:hi], cfg, return_coarse=True, device=dev,
                         **draws_lib.build_kw(draws.fold_in(s), hi - lo, cfg, dev))
        graphs.append(g)
        coarses.append(c)
        comps += int(st.n_comps)
        waves += st.n_waves
        edges += int(st.n_inserted_edges)
    return graphs, coarses, comps, waves, edges


def _wave_seeds(seed_fn, generator, wave, pos, W, n_valid, cfg, coarse, dev):
    """A wave's (seeds, coarse_seeds): ``seed_fn``'s, else drawn from
    ``generator`` (the coarse pass's first, as the reference splits its key)."""
    seeds = coarse_seeds = None
    if seed_fn is not None:
        out = seed_fn(wave, pos, W, n_valid)
        seeds, coarse_seeds = out if isinstance(out, tuple) else (out, None)
    if coarse is not None and cfg.seed_mode == "coarse" and coarse_seeds is None:
        coarse_seeds = search_lib.random_seeds(
            W, cfg.n_seeds, coarse.graph.n_valid, generator, dev
        )
    if seeds is None:
        seeds = search_lib.random_seeds(W, cfg.n_seeds, n_valid, generator, dev)
    seeds = torch.as_tensor(seeds).to(dev)
    return seeds, None if coarse_seeds is None else torch.as_tensor(coarse_seeds).to(dev)


# ---------------------------------------------------------------------------
# Divide-and-conquer construction: sub-builds + symmetric merges
# ---------------------------------------------------------------------------


def partition_bounds(n: int, shards: int):
    """Contiguous partition boundaries (shards + 1 ints, balanced to one
    row), the sharded router's split too."""
    import numpy as np

    if not 1 <= shards <= n:
        raise ValueError(f"need 1 <= shards <= n, got {shards} for n={n}")
    return np.linspace(0, n, shards + 1).astype(int)


def build_parallel(
    x: torch.Tensor,
    cfg: BuildConfig,
    draws=None,
    *,
    shards: int = 2,
    refine_rounds: int = 1,
    search_chunk: int = 512,
    mesh=None,
    return_coarse: bool = False,
    sub_cfg: Optional[BuildConfig] = None,
    merge_scfg: Optional[SearchConfig] = None,
    tracker=None,
    device=None,
):
    """Divide-and-conquer build: ``shards`` contiguous blocks of x, each
    built by ``build`` (``sub_cfg``, default ``cfg``), folded by
    ``merge.merge_subgraphs`` (cross searches at ``merge_scfg``, default
    ``cfg.search_config()``, in chunks of ``search_chunk``), then
    ``refine_rounds`` NN-Descent join rounds.  The graph's ids are the rows
    of x, as in a sequential build.

    Entry points come from ``draws`` (a ``core.draws.Draws``, default
    ``TorchDraws(0)``) along the reference's chain: block s builds from
    ``fold_in(s)``, the merge tree from ``fold_in(1_000_000)`` and a coarse
    level re-derived on the merged graph from ``fold_in(2_000_000)``.
    ``shards=1`` is ``build``.  The blocks build one after another on the
    one device.  With ``mesh``, a ``torch.distributed`` process group of
    ``shards`` ranks that all call with the same arguments, each rank builds
    one block (``distributed.build_subgraphs``, its waves drawing from the
    splits of ``draws`` itself, the reference's mesh chain), the merge
    levels run one pair per rank (each side's cross search one batch, as
    the reference's), rank 0 refines, and every rank returns
    the same graph; ``n % shards`` must be 0.  ``tracker``
    (an ``obs.Tracker``) times the sub-builds (``parallel/subbuild``), each
    merge level and the folds (``merge_subgraphs``) and the refine
    (``parallel/refine``).  ``device``: where to run (None: the card).

    Returns (graph, stats), plus the coarse level when ``return_coarse``:
    the merge tree's root level, or one re-derived under
    ``seed_mode="coarse"`` when no folded level survived, else None.
    """
    from repro_torch.core import hierarchy  # late: hierarchy imports construct
    from repro_torch.obs import NOOP

    dev = device_lib.resolve(device)
    x = stored_data(x, cfg, dev)
    n = x.shape[0]
    draws = draws_lib.TorchDraws(0) if draws is None else draws
    if shards == 1 and mesh is None:
        return build(x, cfg, return_coarse=return_coarse, tracker=tracker, device=dev,
                     **draws_lib.build_kw(draws, n, cfg, dev))
    bounds = partition_bounds(n, shards)
    sub = sub_cfg if sub_cfg is not None else cfg
    trk = tracker if tracker is not None else NOOP
    if mesh is not None:
        from repro_torch.core import distributed  # late: distributed imports construct

        n_ranks = distributed.world_size(mesh)
        if shards != n_ranks:  # before the sub-builds
            raise ValueError(f"the group has {n_ranks} ranks, build_parallel got "
                             f"shards={shards}: on a group, one sub-graph per rank")
    with trk.span("parallel/subbuild") as sp:
        if mesh is not None:
            graphs, coarses, sub_comps, sub_waves, sub_edges = distributed.build_subgraphs(
                mesh, x, sub, draws, device=dev)
        else:
            graphs, coarses, sub_comps, sub_waves, sub_edges = _sub_builds(
                x, sub, draws, bounds, dev)
        sp.synced = True  # the counters' int() (and the all-gather) are the sync
    scfg = merge_scfg if merge_scfg is not None else cfg.search_config()
    g, merge_comps, coarse = merge.merge_subgraphs(
        graphs, x, scfg, draws.fold_in(1_000_000), search_chunk=search_chunk, coarses=coarses,
        mesh=mesh, tracker=tracker)
    with trk.span("parallel/refine") as sp:
        root = mesh is None or distributed.shard_index(mesh) == 0
        if root:
            g, refine_comps = nndescent.refine(g, x, cfg.metric, rounds=refine_rounds)
        if mesh is not None:  # rank 0's refined graph on every rank
            g = distributed.broadcast_graph(g, 0, mesh)
            refine_comps = int(distributed.broadcast(
                torch.tensor(refine_comps if root else 0), 0, mesh))
        sp.sync(g.nbr_ids)
    stats = BuildStats(n_comps=counter(sub_comps + merge_comps + refine_comps, dev),
                       n_waves=sub_waves, n_inserted_edges=counter(sub_edges, dev))
    if not return_coarse:
        return g, stats
    if coarse is None and cfg.seed_mode == "coarse":
        coarse = hierarchy.derive_coarse(
            g, x, cfg, device=dev, **draws_lib.derive_kw(draws.fold_in(2_000_000), g, cfg, dev))
    return g, stats, coarse
