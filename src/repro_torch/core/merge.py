"""Batched ``insertG`` and reverse-list appends (counterpart of the online
build's half of ``repro.core.merge``).

``merge_candidates`` commits a flat stream of (row, id, dist) candidate
edges into the k-NN lists: qualify, dedupe, rank per row, keep k per row,
then a row-wise merge of (old ‖ candidates).  The row-wise merge sorts a
(capacity, 2k) array over every row on every call, as the reference does.
``append_reverse`` is the batched FIFO ring-buffer append.  Both return new
tensors and leave their inputs untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import segments


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
    valid &= ~(nbr_ids[row] == q[:, None]).any(dim=1)  # already in the row

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
    rows, cols = sm[ok].long(), slot[ok].long()
    rev_ids = rev_ids.clone()
    rev_lam = rev_lam.clone()
    rev_ids[rows, cols] = so[ok].to(torch.int32)
    rev_lam[rows, cols] = sl[ok]
    return rev_ids, rev_lam, rev_ptr + counts
