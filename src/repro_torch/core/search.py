"""Batched Enhanced Hill-Climbing (EHC, Alg. 1 and the LGD-aware expansion
of Alg. 3) — counterpart of ``repro.core.search``, with random entry points
and the distance engine at fp32, bf16, int8 or PQ rank-then-rerank
(``SearchConfig.precision``, ``kernels.precision``).

A wave of B queries climbs at once.  Each lane keeps a beam of e (ids,
dists, expanded flags) and a per-lane open-addressing hash of every vertex
it compared (the paper's D array).  One iteration selects the closest
unexpanded beam entry r per lane, expands G[r] ∪ Ḡ[r] with the λ filter
(``_prepare_expansion``), and hands the candidates to one fused expansion
step (``kernels.ops.expand_step``).  A lane is done when its best
unexpanded entry cannot enter its top-k; the loop stops when every lane is
done or after ``max_iters`` iterations — one host read of the ``done`` mask
per iteration stands in for the reference's ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import segments
from repro_torch.core.graph import KNNGraph
from repro_torch.kernels import expand as expand_lib
from repro_torch.kernels import ops, ref
from repro_torch.kernels import precision as precision_lib


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
    """EHC search configuration (random entry points)."""

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

    def __post_init__(self):
        if self.beam < self.k:
            raise ValueError(f"beam must be >= k, got beam={self.beam} k={self.k}")
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
    enc: Optional[precision_lib.EncodedData] = None,
) -> SearchState:
    """One EHC iteration for every lane (done lanes are left unchanged).
    The hash in ``st`` is updated in place; ``enc`` is the compressed table
    matching ``cfg.precision``."""
    cands, beam_exp = _prepare_expansion(g, st, cfg)
    beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, comps = ops.expand_step(
        q, x, cands, st.beam_ids, st.beam_dist, beam_exp, st.vis_ids, st.vis_dist,
        metric=cfg.metric, hash_probes=cfg.hash_probes, sq_norms=g.sq_norms,
        enc=enc, precision=cfg.precision, rerank_keep=cfg.rerank_factor * cfg.k,
    )
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
) -> SearchState:
    """Pre-loop state: the (B, p) entry points deduped, masked to alive
    allocated rows, scored, hashed and merged into an empty beam (Alg. 1
    line 5)."""
    B = q.shape[0]
    e, H = cfg.beam, cfg.hash_slots
    dev = q.device
    seeds = seeds.to(device=dev, dtype=torch.int32)
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
        n_comps=seed_comps,
        n_iters=torch.zeros(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        hash_full=fill < seed_comps,
        fill=fill,
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
    device=None,
) -> SearchResult:
    """Batched EHC search of queries q (B, d) against graph g over x (n, d).

    Entry points are the injected ``seeds`` (B, p) when given, else p
    uniform draws from ``generator``.  ``enc`` is the compressed table
    matching ``cfg.precision`` (ignored for fp32); it is encoded from ``x``
    when absent, int8 reusing ``g.row_scale`` when it covers every row of
    ``x``.  ``device`` is where to run (None: the card, raising without
    one)."""
    dev = device_lib.resolve(device)
    g, x, q = g.to(dev), x.to(dev), q.to(dev)
    if cfg.precision != "fp32":
        if enc is None:
            reuse = cfg.precision == "int8" and g.row_scale.shape[0] == x.shape[0]
            enc = precision_lib.encode_dataset(
                x, cfg.precision, row_scale=g.row_scale if reuse else None
            )
        enc = enc.to(dev)
    if seeds is None:
        seeds = random_seeds(q.shape[0], cfg.n_seeds, g.n_valid, generator, dev)
    st = init_state(g, x, q, seeds, cfg, enc)
    for _ in range(cfg.max_iters):
        if bool(st.done.all()):  # the loop's one host read
            break
        st = step(g, x, q, st, cfg, enc)
    return SearchResult(
        ids=st.beam_ids[:, : cfg.k],
        dists=st.beam_dist[:, : cfg.k],
        vis_ids=st.vis_ids,
        vis_dist=st.vis_dist,
        n_comps=st.n_comps,
        n_iters=st.n_iters,
        converged=st.done,
        hash_full=st.hash_full,
    )
