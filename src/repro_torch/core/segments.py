"""Sort-based group-by primitives (counterpart of ``repro.core.segments``).

Key columns are sorted ascending by the caller (stable sorts only); padding
entries carry a sentinel key >= num_segments so they sort to the tail.
Scatters write only entries whose destination is unique, so no result
depends on the order a device resolves duplicate indices in.
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
    """(num_segments,) occurrence count per key; keys >= num_segments dropped."""
    valid = sorted_keys < num_segments
    counts = torch.bincount(sorted_keys[valid].long(), minlength=num_segments)
    return counts[:num_segments].to(torch.int32)


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
    row = sorted_keys[ok].long()
    col = rank[ok].long()
    buffers = []
    for payload, fill in zip(payloads, fills):
        buf = torch.full(
            (num_segments, r), fill, dtype=payload.dtype, device=payload.device
        )
        buf[row, col] = payload[ok]
        buffers.append(buf)
    return buffers, segment_counts(sorted_keys, num_segments)
