"""Two-level entry-point hierarchy: a coarse landmark graph plus a
landmark -> member table (counterpart of ``repro.core.hierarchy``).

* L ≈ 4·√n landmark rows are sampled; their vectors are copied as the
  routing ``points`` (frozen: removals only mask seeds, never routing);
* a k-NN graph over the landmarks is built by ``construct.build`` itself,
  with random seeding (the recursion stops there);
* a ring table assigns full-graph rows to their winning landmark's cell.
  During online construction the assignment is free: an inserted row's own
  coarse search knows its top-1 landmark (``SearchResult.seed_cell``), and
  ``construct.wave_core`` appends it (``note_inserted``), the same FIFO
  ring append as the reverse lists.

``search.init_state`` under ``seed_mode="coarse"`` consumes the level.
Removals mask rows (``purge_rows``), compaction remaps them
(``remap_rows``), and a level can be re-derived from a live graph
(``derive_coarse``).  Landmarks are drawn from a ``torch.Generator`` unless
the caller injects them (``landmark_rows``), and the landmark graph's entry
points likewise (``seed_fn``).  ``fold_coarse`` folds the levels of two
merged blocks into one (the divide-and-conquer build's merge tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import construct, merge
from repro_torch.core.graph import KNNGraph
from repro_torch.kernels import ops


class CoarseLevel(NamedTuple):
    """The coarse entry-point level."""

    landmark_rows: torch.Tensor  # (L,) int32 full-graph row per landmark; -1 = dead
    points: torch.Tensor  # (L, d) float32 frozen routing vectors
    graph: KNNGraph  # k-NN graph over the landmarks (local ids [0, L))
    members: torch.Tensor  # (L, M) int32 ring table of full-graph rows; -1 empty
    mem_ptr: torch.Tensor  # (L,) int32 total appends (ring cursors)

    @property
    def n_landmarks(self) -> int:
        return self.landmark_rows.shape[0]

    def to(self, device) -> "CoarseLevel":
        return CoarseLevel(
            landmark_rows=self.landmark_rows.to(device),
            points=self.points.to(device),
            graph=self.graph.to(device),
            members=self.members.to(device),
            mem_ptr=self.mem_ptr.to(device),
        )


def default_landmarks(n: int) -> int:
    """L ≈ 4·√n, clamped to [32, 4096]."""
    return max(32, min(4096, int(4 * math.sqrt(max(n, 1)))))


def coarse_build_config(cfg):
    """The landmark graph's BuildConfig: the same machinery, random seeding."""
    return dataclasses.replace(cfg, seed_mode="random", coarse_landmarks=None)


def nearest_landmark(
    points: torch.Tensor, xs: torch.Tensor, metric: str, *, chunk: int = 4096
) -> torch.Tensor:
    """Brute top-1 landmark per row of xs (T,) int32, in chunks of rows,
    each one ``ops.pairwise_distance`` call (ties to the lower landmark)."""
    outs = [
        torch.argmin(ops.pairwise_distance(xs[lo:lo + chunk], points, metric), dim=1)
        for lo in range(0, xs.shape[0], chunk)
    ]
    if not outs:
        return torch.zeros((0,), dtype=torch.int32, device=xs.device)
    return torch.cat(outs).to(torch.int32)


def note_inserted(coarse: CoarseLevel, rows: torch.Tensor, cells: torch.Tensor) -> CoarseLevel:
    """Append freshly inserted full-graph ``rows`` to their winning
    ``cells`` (FIFO ring); negative rows or cells are padding."""
    members, _, mem_ptr = merge.append_reverse(
        coarse.members, torch.zeros_like(coarse.members), coarse.mem_ptr,
        owner=rows.to(torch.int32), member=cells.to(torch.int32),
    )
    return coarse._replace(members=members, mem_ptr=mem_ptr)


def purge_rows(coarse: CoarseLevel, removed: torch.Tensor) -> CoarseLevel:
    """Mask removed full-graph rows out of the level.  ``removed`` is the
    (cap,) bool mask of removed rows.  A removed landmark keeps its routing
    vector, but its dead row (and any dead member) stops seeding."""
    cap = removed.shape[0]

    def mask(a):
        hit = (a >= 0) & (a < cap) & removed[a.clamp(0, cap - 1).long()]
        return torch.where(hit, -1, a)

    return coarse._replace(
        landmark_rows=mask(coarse.landmark_rows), members=mask(coarse.members)
    )


def remap_rows(coarse: CoarseLevel, id_map: torch.Tensor) -> CoarseLevel:
    """Rewrite full-graph row references through a compaction ``id_map``
    ((cap,) old -> new, -1 = dead)."""
    cap = id_map.shape[0]
    id_map = id_map.to(coarse.members.device)

    def m(a):
        mapped = id_map[a.clamp(0, cap - 1).long()].to(torch.int32)
        return torch.where((a >= 0) & (a < cap), mapped, -1)

    return coarse._replace(landmark_rows=m(coarse.landmark_rows), members=m(coarse.members))


def _assemble(
    x: torch.Tensor,
    landmark_rows: torch.Tensor,
    cfg,
    assign_rows: Optional[torch.Tensor],
    *,
    seed_fn=None,
    generator: Optional[torch.Generator] = None,
) -> tuple[CoarseLevel, int]:
    """The landmark graph and member table for given landmark rows; returns
    (level, comparisons charged: the landmark build and the assignment)."""
    dev = x.device
    landmark_rows = landmark_rows.to(device=dev, dtype=torch.int32)
    points = x[landmark_rows.long()]
    gc, stats = construct.build(
        points, coarse_build_config(cfg), seed_fn=seed_fn, generator=generator, device=dev
    )
    comps = int(stats.n_comps)
    L = landmark_rows.shape[0]
    level = CoarseLevel(
        landmark_rows=landmark_rows,
        points=points,
        graph=gc,
        members=torch.full((L, cfg.coarse_members), -1, dtype=torch.int32, device=dev),
        mem_ptr=torch.zeros((L,), dtype=torch.int32, device=dev),
    )
    if assign_rows is not None and assign_rows.shape[0]:
        assign_rows = assign_rows.to(dev)
        cells = nearest_landmark(points, x[assign_rows.long()], cfg.metric)
        comps += int(assign_rows.shape[0]) * L
        level = note_inserted(level, assign_rows, cells)
    return level, comps


def build_coarse(
    x: torch.Tensor,
    cfg,
    *,
    assign_rows: Optional[torch.Tensor] = None,
    landmark_rows: Optional[torch.Tensor] = None,
    seed_fn=None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> tuple[CoarseLevel, int]:
    """Sample L landmarks over the whole of x (rows not inserted yet route
    from the first wave and seed once they commit) and build the level;
    ``assign_rows`` (the seed-graph prefix) get a brute cell assignment.
    Returns (level, comps) for the caller to charge to the scanning rate."""
    dev = device_lib.resolve(device)
    x = x.to(dev)
    n = x.shape[0]
    L = min(cfg.coarse_landmarks or default_landmarks(n), n)
    if landmark_rows is None:
        landmark_rows = torch.randperm(n, generator=generator, device=dev)[:L]
    return _assemble(x, landmark_rows, cfg, assign_rows, seed_fn=seed_fn, generator=generator)


def fold_coarse(
    ca: Optional[CoarseLevel],
    cb: Optional[CoarseLevel],
    n_a: int,
    scfg,
    draws,
) -> tuple[Optional[CoarseLevel], int]:
    """Fold the levels of two merged blocks into one level of the merged
    graph.  ``ca`` routes rows [0, n_a), ``cb`` the right block in its local
    rows, which are offset by n_a (as ``merge.stack_subgraphs`` offsets the
    graphs).  The landmark graphs merge by ``merge.symmetric_merge`` over
    the concatenated routing points, random-seeded from ``draws`` (a
    ``core.draws.Draws``), and the member rings concatenate.  Either side
    missing gives no level.  Returns (level or None, comps of the landmark
    merge)."""
    if ca is None or cb is None:
        return None, 0
    points = torch.cat([ca.points, cb.points])
    gc, comps = merge.symmetric_merge(ca.graph, cb.graph, points, scfg, draws)

    def off(a):
        return torch.where(a >= 0, a + n_a, -1)

    level = CoarseLevel(
        landmark_rows=torch.cat([ca.landmark_rows, off(cb.landmark_rows)]),
        points=points,
        graph=gc,
        members=torch.cat([ca.members, off(cb.members)]),
        mem_ptr=torch.cat([ca.mem_ptr, cb.mem_ptr]),
    )
    return level, comps


def derive_coarse(
    g: KNNGraph,
    x: torch.Tensor,
    cfg,
    *,
    landmark_rows: Optional[torch.Tensor] = None,
    seed_fn=None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> CoarseLevel:
    """Re-derive a level from a live graph: landmarks sampled from alive
    rows only, every alive row assigned to its nearest landmark.
    Maintenance work, charged to no scanning rate."""
    dev = device_lib.resolve(device)
    x = x.to(dev)
    rows = torch.nonzero(g.alive[: g.n_valid].to(dev))[:, 0].to(torch.int32)
    if rows.numel() == 0:
        raise ValueError("derive_coarse needs a graph with at least one alive row")
    L = min(cfg.coarse_landmarks or default_landmarks(rows.numel()), rows.numel())
    if landmark_rows is None:
        landmark_rows = rows[torch.randperm(rows.numel(), generator=generator, device=dev)[:L]]
    level, _ = _assemble(x, landmark_rows, cfg, rows, seed_fn=seed_fn, generator=generator)
    return level
