"""Sort-based group-by primitives (counterpart of ``repro.core.segments``).

Key columns are sorted ascending by the caller (stable sorts only); padding
entries carry a sentinel key >= num_segments so they sort to the tail.
Scatters write only entries whose destination is unique, so no result
depends on the order a device resolves duplicate indices in.

Every shape here follows from the input shapes alone, never from the data:
entries that are not written go to an extra dump row that is sliced off
(``scatter_rows``), the reference's ``mode="drop"``.  So these functions
never read a value back to the host, and they trace under
``FakeTensorMode`` (the dry run's ``configs.cells``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(T,) sorted keys -> (T,) bool, True where a new segment begins."""
    first = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    return torch.cat([first, sorted_keys[1:] != sorted_keys[:-1]])


def segment_rank(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each element within its run of equal keys."""
    idx = torch.arange(sorted_keys.shape[0], device=sorted_keys.device)
    if idx.numel() == 0:
        return idx.to(torch.int32)
    starts = segment_starts(sorted_keys)
    seg_start = torch.cummax(torch.where(starts, idx, 0), dim=0).values
    return (idx - seg_start).to(torch.int32)


def segment_counts(sorted_keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments,) occurrence count per key; keys >= num_segments dropped
    (counted in a dump slot that is sliced off)."""
    slot = sorted_keys.clamp_max(num_segments).long()
    counts = slot.new_zeros(num_segments + 1).scatter_add(0, slot, torch.ones_like(slot))
    return counts[:num_segments].to(torch.int32)


def scatter_rows(
    buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor,
    ok: torch.Tensor,
) -> torch.Tensor:
    """``buf[rows[ok], cols[ok]] = values[ok]`` on whole tensors: a new
    (N, r) tensor, ``buf`` untouched.  Entries that fail ``ok`` write into
    an extra dump row that is sliced off, so the written destinations must
    be unique and the others may be anything."""
    n = buf.shape[0]
    out = torch.cat([buf, buf.new_empty((1,) + tuple(buf.shape[1:]))])
    out.index_put_(
        (torch.where(ok, rows.long(), n), torch.where(ok, cols.long(), 0)),
        values.to(buf.dtype),
    )
    return out[:n]


def mask_row_duplicates(ids: torch.Tensor) -> torch.Tensor:
    """(B, C) int ids -> (B, C) bool, True at every later copy of an id >= 0."""
    B = ids.shape[0]
    order = torch.argsort(ids, dim=1, stable=True)
    s = torch.gather(ids, 1, order)
    first = torch.zeros((B, 1), dtype=torch.bool, device=ids.device)
    dup_sorted = torch.cat([first, (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)], dim=1)
    return torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)


def grouped_top_r(
    sorted_keys: torch.Tensor,
    payloads: Sequence[torch.Tensor],
    fills: Sequence,
    num_segments: int,
    r: int,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scatter the first ``r`` elements of each segment into dense buffers.

    Returns one (num_segments, r) buffer per payload and the (num_segments,)
    uncapped occurrence count per segment.
    """
    rank = segment_rank(sorted_keys)
    ok = (sorted_keys < num_segments) & (rank < r)
    buffers = [
        scatter_rows(payload.new_full((num_segments, r), fill), sorted_keys, rank, payload, ok)
        for payload, fill in zip(payloads, fills)
    ]
    return buffers, segment_counts(sorted_keys, num_segments)
