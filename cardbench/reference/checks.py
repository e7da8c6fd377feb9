"""The numbers that decide ``correct``, each held to a limit: a run is
correct when every number is at or under its limit (``judge``).

Each function takes the program's outputs as the run kept them and the
benchmark's own rows and queries; the exact answers come from
``reference.exact``.
"""

from __future__ import annotations

import torch

from cardbench.reference import exact


def bad_rows(ids: torch.Tensor, dists: torch.Tensor, n: int, *, self_ids=None) -> int:
    """Rows of an answer that break its form: an id at or past n or below
    -1, an id twice, the row's own id (``self_ids``), or the distances of
    the valid ids, in the row's order, not ascending (NaN included).  -1
    entries (absent answers) are counted by ``short_rows`` and ``holes``."""
    ids = ids.long()
    valid = ids >= 0
    bad = ((ids >= n) | (ids < -1)).any(1)
    holes = -1 - torch.arange(ids.shape[1], device=ids.device)
    srt = torch.sort(torch.where(valid, ids, holes), dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    if self_ids is not None:
        bad |= (ids == self_ids.to(ids.device).long()[:, None]).any(1)
    d = dists.to(ids.device).double()
    bad |= (valid & torch.isnan(d)).any(1)
    before = torch.cummax(torch.where(valid, d, float("-inf")), dim=1).values[:, :-1]
    bad |= (valid[:, 1:] & (d[:, 1:] < before)).any(1)
    return int(bad.sum())


def short_rows(ids: torch.Tensor, k: int) -> int:
    """Answers with fewer than ``k`` valid ids: a -1 anywhere among the
    first k, empty answers included (``k`` is min(top_k, rows indexed))."""
    return int(((ids[:, :k] >= 0).sum(1) < k).sum())


def holes(ids: torch.Tensor) -> int:
    """Lists with a -1 before a valid id, or with no valid id at all.  A
    graph list may end in -1 padding (LGD prunes it); a gap inside is not
    padding."""
    valid = ids >= 0
    later = torch.flip(torch.cummax(torch.flip(valid.int(), [1]), dim=1).values, [1]).bool()
    inner = (~valid[:, :-1] & later[:, 1:]).any(1)
    return int((inner | ~valid.any(1)).sum())


def dist_err(x, q, ids, dists, metric) -> float:
    """Largest gap between a reported distance and the float64 distance of
    the same id, as a share of the entry's scale (``exact.distances``);
    invalid ids are ``bad_rows``' to count."""
    ids = ids.to(x.device)
    ref, scale = exact.distances(x, q, ids, metric)
    ok = (ids >= 0) & (ids < x.shape[0])
    gap = (dists.to(x.device).double() - ref).abs() / scale
    gap = torch.where(ok, gap, 0.0)
    return float(gap.max()) if gap.numel() else 0.0


def recall(ids, truth_ids, k: int) -> float:
    """|answer ∩ truth| / (m k) over the first k of each row."""
    a = ids[:, :k].to(truth_ids.device).long()
    hits = ((a[:, :, None] == truth_ids[:, None, :k]) & (a[:, :, None] >= 0)).sum()
    return int(hits) / (a.shape[0] * k)


def rank_gap(x, q, ids, truth_d, metric) -> float:
    """Largest amount by which the j-th best float64 distance among the
    answer's ids exceeds the exact j-th distance, as a share of the scale:
    0 for an exact answer up to float32 ties."""
    ids = ids.to(x.device)
    ref, scale = exact.distances(x, q, ids, metric)
    ref = torch.where(torch.isnan(ref), float("inf"), ref)
    got = torch.sort(ref, dim=1).values
    k = truth_d.shape[1]
    gap = (got[:, :k] - truth_d.to(x.device)) / scale[:, :k]
    return float(gap.max()) if gap.numel() else 0.0


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a limit with no number, or a number that is not finite, fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok &= good
        out[name] = {"value": v, "limit": limit}
    return ok, out
