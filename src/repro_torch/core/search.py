"""Batched Enhanced Hill-Climbing (EHC, Alg. 1 and the LGD-aware expansion
of Alg. 3) — counterpart of ``repro.core.search``, with random or coarse
(``core.hierarchy``) entry points and the distance engine at fp32, bf16,
int8 or PQ rank-then-rerank (``SearchConfig.precision``,
``kernels.precision``).

A wave of B queries climbs at once.  Each lane keeps a beam of e (ids,
dists, expanded flags) and a per-lane open-addressing hash of every vertex
it compared (the paper's D array).  One iteration selects the closest
unexpanded beam entry r per lane, expands G[r] ∪ Ḡ[r] with the λ filter
(``_prepare_expansion``), and hands the candidates to one fused expansion
step (``kernels.ops.expand_step``).  A lane is done when its best
unexpanded entry cannot enter its top-k; the loop stops when every lane is
done or after ``max_iters`` iterations — one host read of the ``done`` mask
per iteration stands in for the reference's ``lax.while_loop``.

With a tracker (``obs``) the call reports ``search/init``, then per
iteration ``search/done_read`` around that read and ``search/step`` around
the iteration, whose children are ``search/select``, ``search/expand`` and
``search/update``.  None of them waits for the card: the ``done`` read is
the loop's only wait, tracker or not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import segments
from repro_torch.core.graph import KNNGraph
from repro_torch.kernels import expand as expand_lib
from repro_torch.kernels import ops, ref
from repro_torch.kernels import precision as precision_lib
from repro_torch.obs import NOOP


def auto_hash_slots(beam: int, max_iters: int) -> int:
    """The next power of two above ``beam * max_iters / 2``, clamped to
    [1024, 65536] (the reference's heuristic; ``hash_full`` reports
    saturation)."""
    est = (beam * max_iters) // 2
    H = 1024
    while H < est and H < (1 << 16):
        H <<= 1
    return H


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """EHC search configuration.

    ``seed_mode="coarse"`` seeds each lane from a short EHC pass over a
    coarse landmark graph (a ``core.hierarchy.CoarseLevel``): the winning
    ``coarse_top`` landmarks' rows, their member cells, then the p random
    entry points."""

    k: int = 10  # result size; also the improvement-termination horizon
    beam: int = 64  # beam width e >= k
    n_seeds: int = 8  # p random entry points
    hash_slots: Optional[int] = None  # H, a power of two; None auto-sizes
    hash_probes: int = 8  # linear-probe depth
    max_iters: int = 64  # straggler cap on expansions
    metric: str = "l2"
    use_reverse: bool = True  # False = plain HC: G[r] only
    use_lgd_mask: bool = False  # λ <= mean-λ expansion filter (Alg. 3)
    hard_diversify: bool = False  # ablation: skip any λ > 0
    precision: str = "fp32"  # "fp32" | "bf16" | "int8" | "pq"
    rerank_factor: int = 4  # pq: exact re-rank width = rerank_factor * k
    seed_mode: str = "random"  # "random" | "coarse"
    coarse_top: int = 4  # T winning landmarks whose cells seed the beam
    coarse_beam: int = 16  # beam width of the coarse EHC pass
    coarse_iters: int = 16  # max_iters of the coarse EHC pass

    def __post_init__(self):
        if self.beam < self.k:
            raise ValueError(f"beam must be >= k, got beam={self.beam} k={self.k}")
        if self.seed_mode not in ("random", "coarse"):
            raise ValueError(f"seed_mode must be 'random' or 'coarse', got {self.seed_mode!r}")
        precision_lib.validate_precision(self.precision)
        if self.rerank_factor < 1:
            raise ValueError(f"rerank_factor must be >= 1, got {self.rerank_factor}")
        if self.hash_slots is None:
            object.__setattr__(
                self, "hash_slots", auto_hash_slots(self.beam, self.max_iters)
            )
        if self.hash_slots & (self.hash_slots - 1):
            raise ValueError(f"hash_slots must be a power of two, got {self.hash_slots}")


class SearchResult(NamedTuple):
    ids: torch.Tensor  # (B, k) int32 top-k ids, ascending distance
    dists: torch.Tensor  # (B, k) float32
    vis_ids: torch.Tensor  # (B, H) int32 — every vertex compared (D keys)
    vis_dist: torch.Tensor  # (B, H) float32 — m(q, vertex) (D values)
    n_comps: torch.Tensor  # (B,) int32 — distance computations
    n_iters: torch.Tensor  # (B,) int32 — expansions until convergence
    converged: torch.Tensor  # (B,) bool — False = stopped by max_iters
    hash_full: torch.Tensor  # (B,) bool — some computed distance was not
    #   recorded in the D array (probe depth exhausted or slot collision)
    seed_cell: torch.Tensor  # (B,) int32 — winning coarse landmark, -1 under
    #   random seeding (assigns an inserted row to its cell for free)


class SearchState(NamedTuple):
    beam_ids: torch.Tensor
    beam_dist: torch.Tensor
    beam_exp: torch.Tensor
    vis_ids: torch.Tensor
    vis_dist: torch.Tensor
    n_comps: torch.Tensor
    n_iters: torch.Tensor
    done: torch.Tensor
    hash_full: torch.Tensor
    fill: torch.Tensor  # (B,) occupied hash slots
    seed_cell: torch.Tensor  # (B,) int32


def _hash_fill(vis_ids: torch.Tensor) -> torch.Tensor:
    return (vis_ids >= 0).sum(dim=1).to(torch.int32)


def _row_mean_lambda(lam_row: torch.Tensor, ids_row: torch.Tensor) -> torch.Tensor:
    """Mean λ over the valid entries of a k-NN list: λ̄(r), float32."""
    valid = ids_row >= 0
    cnt = valid.sum(dim=-1).clamp_min(1)
    total = torch.where(valid, lam_row, 0).sum(dim=-1)
    return total.float() / cnt.float()


def _candidates_from_expansion(
    g: KNNGraph, r_id: torch.Tensor, has_r: torch.Tensor, cfg: SearchConfig
) -> torch.Tensor:
    """Expand r: G[r] ∪ Ḡ[r] with the LGD mask; (B, k+R) ids, -1 masked."""
    safe_r = r_id.clamp_min(0).long()
    fwd_ids = g.nbr_ids[safe_r]
    rev_ids = g.rev_ids[safe_r]
    if not cfg.use_reverse:
        rev_ids = torch.full_like(rev_ids, -1)
    if cfg.use_lgd_mask or cfg.hard_diversify:
        fwd_lam = g.nbr_lam[safe_r]
        mean_lam = _row_mean_lambda(fwd_lam, fwd_ids)[:, None]
        if cfg.hard_diversify:
            fwd_keep = fwd_lam <= 0
        else:
            fwd_keep = fwd_lam.float() <= mean_lam  # Alg. 3 line 15 (<=)
        fwd_ids = torch.where(fwd_keep, fwd_ids, -1)
        # reverse edges by their forward twin's λ, snapshot in rev_lam
        rev_lam = g.rev_lam[safe_r].float()
        rev_keep = rev_lam <= 0 if cfg.hard_diversify else rev_lam < mean_lam  # line 19 (<)
        rev_ids = torch.where(rev_keep, rev_ids, -1)
    cands = torch.cat([fwd_ids, rev_ids], dim=1)
    cands = torch.where(has_r[:, None], cands, -1)
    in_range = (cands >= 0) & (cands < g.n_valid)
    alive = g.alive[cands.clamp(0, g.capacity - 1).long()]
    cands = torch.where(in_range & alive, cands, -1)
    return torch.where(segments.mask_row_duplicates(cands), -1, cands)


def _prepare_expansion(g: KNNGraph, st: SearchState, cfg: SearchConfig):
    """Select r (closest unexpanded beam entry per lane), mark it expanded,
    and emit its masked candidates.  Returns (cands (B, C), beam_exp)."""
    sel_dist = torch.where(st.beam_exp, float("inf"), st.beam_dist)
    r_slot = torch.argmin(sel_dist, dim=1)
    r_best = torch.gather(sel_dist, 1, r_slot[:, None])[:, 0]
    has_r = torch.isfinite(r_best) & ~st.done
    r_id = torch.where(has_r, torch.gather(st.beam_ids, 1, r_slot[:, None])[:, 0], -1)
    beam_exp = st.beam_exp.clone()
    rows = torch.arange(beam_exp.shape[0], device=beam_exp.device)
    beam_exp[rows, r_slot] |= has_r
    return _candidates_from_expansion(g, r_id, has_r, cfg), beam_exp


def step(
    g: KNNGraph, x: torch.Tensor, q: torch.Tensor, st: SearchState, cfg: SearchConfig,
    enc: Optional[precision_lib.EncodedData] = None, *, tracker=None,
) -> SearchState:
    """One EHC iteration for every lane (done lanes are left unchanged).
    The hash in ``st`` is updated in place; ``enc`` is the compressed table
    matching ``cfg.precision``; ``tracker`` (``obs``) gets the
    ``search/select``, ``search/expand`` and ``search/update`` spans."""
    trk = tracker or NOOP
    with trk.span("search/select"):
        cands, beam_exp = _prepare_expansion(g, st, cfg)
    with trk.span("search/expand"):
        beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, comps = ops.expand_step(
            q, x, cands, st.beam_ids, st.beam_dist, beam_exp, st.vis_ids, st.vis_dist,
            metric=cfg.metric, hash_probes=cfg.hash_probes, sq_norms=g.sq_norms,
            enc=enc, precision=cfg.precision, rerank_keep=cfg.rerank_factor * cfg.k,
        )
    with trk.span("search/update"):
        fill = _hash_fill(vis_ids)
        # every computed distance must land in the D array; a fill delta below
        # the comparison count means an insert was dropped
        hash_full = st.hash_full | (fill - st.fill < comps)
        best_unexp = torch.where(beam_exp, float("inf"), beam_dist).amin(dim=1)
        newly_done = ~(best_unexp < beam_dist[:, cfg.k - 1])
        return SearchState(
            beam_ids=beam_ids,
            beam_dist=beam_dist,
            beam_exp=beam_exp,
            vis_ids=vis_ids,
            vis_dist=vis_dist,
            n_comps=st.n_comps + comps,
            n_iters=st.n_iters + (~st.done).to(torch.int32),
            done=st.done | newly_done,
            hash_full=hash_full,
            fill=fill,
            seed_cell=st.seed_cell,
        )


def coarse_config(cfg: SearchConfig) -> SearchConfig:
    """The short coarse-graph pass of a ``seed_mode="coarse"`` config:
    top-``coarse_top`` over a small beam and few iterations, random seeding,
    no LGD filter, exact fp32 distances."""
    return dataclasses.replace(
        cfg,
        k=cfg.coarse_top,
        beam=max(cfg.coarse_beam, cfg.coarse_top),
        hash_slots=None,
        max_iters=cfg.coarse_iters,
        use_lgd_mask=False,
        hard_diversify=False,
        seed_mode="random",
        precision="fp32",
    )


def random_seeds(
    B: int, p: int, n_valid: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """(B, p) int32 entry points drawn uniformly from [0, max(n_valid, 1))."""
    return torch.randint(
        0, max(n_valid, 1), (B, p), generator=generator, device=device,
        dtype=torch.int32,
    )


def init_state(
    g: KNNGraph, x: torch.Tensor, q: torch.Tensor, seeds: torch.Tensor,
    cfg: SearchConfig, enc: Optional[precision_lib.EncodedData] = None,
    *, coarse: Any = None, coarse_seeds: Optional[torch.Tensor] = None,
) -> SearchState:
    """Pre-loop state: the (B, p) entry points deduped, masked to alive
    allocated rows, scored, hashed and merged into an empty beam (Alg. 1
    line 5).

    Under ``seed_mode="coarse"`` a short EHC pass over ``coarse`` (a
    ``core.hierarchy.CoarseLevel``) from ``coarse_seeds`` (B, p) landmark
    entry points comes first: the winners' landmark rows and member cells
    go ahead of ``seeds``, the pass's comparisons are pre-charged and its
    ``hash_full`` carried, and its top-1 landmark is ``seed_cell``."""
    B = q.shape[0]
    e, H = cfg.beam, cfg.hash_slots
    dev = q.device
    seeds = seeds.to(device=dev, dtype=torch.int32)
    if cfg.seed_mode == "coarse":
        if coarse is None or coarse_seeds is None:
            raise ValueError(
                "seed_mode='coarse' needs a coarse level (core.hierarchy.CoarseLevel) "
                "and its entry points"
            )
        cres = search(coarse.graph, coarse.points, q, coarse_config(cfg),
                      seeds=coarse_seeds, device=dev)
        win = cres.ids  # (B, T) landmark indices, -1 padded
        safe = win.clamp_min(0).long()
        lm_rows = torch.where(win >= 0, coarse.landmark_rows[safe], -1)
        members = torch.where(win[:, :, None] >= 0, coarse.members[safe], -1).reshape(B, -1)
        seeds = torch.cat([lm_rows, members, seeds], dim=1)
        seed_cell = win[:, 0].contiguous()
        pre_comps, pre_full = cres.n_comps, cres.hash_full
    else:
        seed_cell = torch.full((B,), -1, dtype=torch.int32, device=dev)
        pre_comps = torch.zeros(B, dtype=torch.int32, device=dev)
        pre_full = torch.zeros(B, dtype=torch.bool, device=dev)
    seeds = torch.where(segments.mask_row_duplicates(seeds), -1, seeds)
    in_range = (seeds >= 0) & (seeds < g.n_valid)
    alive = g.alive[seeds.clamp(0, g.capacity - 1).long()]
    seeds = torch.where(in_range & alive, seeds, -1)
    # seed distances enter the beam and the hash: the engine's own under
    # bf16/int8, exact under pq (ADC scores never enter the hash)
    seed_precision = cfg.precision if cfg.precision in ("bf16", "int8") else "fp32"
    seed_dist = ops.gather_distance(
        q, x, seeds, cfg.metric, sq_norms=g.sq_norms,
        enc=enc if seed_precision != "fp32" else None, precision=seed_precision,
    )

    vis_ids = torch.full((B, H), -1, dtype=torch.int32, device=dev)
    vis_dist = torch.full((B, H), float("inf"), dtype=torch.float32, device=dev)
    _, ins_ok, ins_slot = expand_lib.hash_probe_state(vis_ids, seeds, cfg.hash_probes)
    expand_lib.record(vis_ids, vis_dist, seeds, seed_dist, (seeds >= 0) & ins_ok, ins_slot)

    cat_ids = torch.cat([torch.full((B, e), -1, dtype=torch.int32, device=dev), seeds], 1)
    cat_dist = torch.cat(
        [torch.full((B, e), float("inf"), dtype=torch.float32, device=dev), seed_dist], 1
    )
    cat_exp = torch.cat([torch.ones((B, e), dtype=torch.bool, device=dev), seeds < 0], 1)
    sel = torch.sort(ref.sort_key(cat_dist), dim=1, stable=True).indices[:, :e]
    seed_comps = (seeds >= 0).sum(dim=1).to(torch.int32)
    fill = _hash_fill(vis_ids)
    return SearchState(
        beam_ids=torch.gather(cat_ids, 1, sel),
        beam_dist=torch.gather(cat_dist, 1, sel),
        beam_exp=torch.gather(cat_exp, 1, sel),
        vis_ids=vis_ids,
        vis_dist=vis_dist,
        n_comps=pre_comps + seed_comps,
        n_iters=torch.zeros(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        hash_full=pre_full | (fill < seed_comps),
        fill=fill,
        seed_cell=seed_cell,
    )


def search(
    g: KNNGraph,
    x: torch.Tensor,
    q: torch.Tensor,
    cfg: SearchConfig,
    *,
    seeds: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    enc: Optional[precision_lib.EncodedData] = None,
    coarse: Any = None,
    coarse_seeds: Optional[torch.Tensor] = None,
    device=None,
    tracker=None,
) -> SearchResult:
    """Batched EHC search of queries q (B, d) against graph g over x (n, d).

    Entry points are the injected ``seeds`` (B, p) when given, else p
    uniform draws from ``generator``.  ``seed_mode="coarse"`` also needs
    ``coarse`` (a ``core.hierarchy.CoarseLevel``) and takes the coarse
    pass's (B, p) landmark entry points from ``coarse_seeds``, else from
    ``generator`` (drawn before ``seeds``).  ``enc`` is the compressed table
    matching ``cfg.precision`` (ignored for fp32); it is encoded from ``x``
    when absent, int8 reusing ``g.row_scale`` when it covers every row of
    ``x``.  ``device`` is where to run (None: the card, raising without
    one).  ``tracker`` (``obs``) gets the spans of the module doc."""
    dev = device_lib.resolve(device)
    g, x, q = g.to(dev), x.to(dev), q.to(dev)
    if cfg.precision != "fp32":
        if enc is None:
            reuse = cfg.precision == "int8" and g.row_scale.shape[0] == x.shape[0]
            enc = precision_lib.encode_dataset(
                x, cfg.precision, row_scale=g.row_scale if reuse else None
            )
        enc = enc.to(dev)
    trk = tracker or NOOP
    with trk.span("search/init"):
        if cfg.seed_mode == "coarse" and coarse is not None and coarse_seeds is None:
            coarse_seeds = random_seeds(
                q.shape[0], cfg.n_seeds, coarse.graph.n_valid, generator, dev
            )
        if seeds is None:
            seeds = random_seeds(q.shape[0], cfg.n_seeds, g.n_valid, generator, dev)
        st = init_state(g, x, q, seeds, cfg, enc, coarse=coarse, coarse_seeds=coarse_seeds)
    # ``step`` gets a tracker only when the caller gave one, so a stand-in
    # for it that takes ``step``'s six positional arguments runs untraced
    step_kw = {} if tracker is None else {"tracker": tracker}
    for _ in range(cfg.max_iters):
        with trk.span("search/done_read"):
            done = bool(st.done.all())  # the loop's one host read
        if done:
            break
        with trk.span("search/step"):
            st = step(g, x, q, st, cfg, enc, **step_kw)
    return result(st, cfg)


def result(st: SearchState, cfg: SearchConfig) -> SearchResult:
    """The search's result from its state after the last iteration."""
    return SearchResult(
        ids=st.beam_ids[:, : cfg.k],
        dists=st.beam_dist[:, : cfg.k],
        vis_ids=st.vis_ids,
        vis_dist=st.vis_dist,
        n_comps=st.n_comps,
        n_iters=st.n_iters,
        converged=st.done,
        hash_full=st.hash_full,
        seed_cell=st.seed_cell,
    )
