"""Table lookup and EmbeddingBag, the recommender models' hot path
(counterpart of ``repro.models.embedding``).

* single-hot lookup = ``index_select`` of rows, ids < 0 give zero rows;
* multi-hot bag     = the flattened (B*L, dim) gather reduced by
  ``index_add_`` into the batch rows (sum or mean), padding (-1) adding zero;
* ``TableConfig.hash_rows`` folds a large id space into fewer rows with the
  quotient-remainder hash.

Ids index in int64: the CTR models' field-offset ids reach 3.9e7 at full
width, and the hash's sum must not wrap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import common, sharding


@dataclasses.dataclass(frozen=True)
class TableConfig:
    rows: int
    dim: int
    hash_rows: int = 0  # 0 = direct indexing; >0 = QR-hash into this many rows


def init_table(generator: torch.Generator, cfg: TableConfig, dtype=torch.float32) -> torch.Tensor:
    rows = cfg.hash_rows or cfg.rows
    return common.embed_init(generator, (rows, cfg.dim), dtype, scale=0.05)


def _resolve_ids(ids: torch.Tensor, cfg: TableConfig) -> torch.Tensor:
    if cfg.hash_rows:
        # quotient-remainder: (id % H + id // H) mod H keeps collisions spread
        h = cfg.hash_rows
        return ((ids % h) + (ids // h)) % h
    return ids


def lookup(table: torch.Tensor, ids: torch.Tensor,
           cfg: Optional[TableConfig] = None) -> torch.Tensor:
    """Single-hot rows: ids (...,) -> (..., dim); ids < 0 give zeros."""
    ids = ids.long()
    if cfg is not None:
        ids = torch.where(ids >= 0, _resolve_ids(ids.clamp(min=0), cfg), -1)
    valid = ids >= 0
    if sharding.row_split(table):  # a table split over ranks: each looks up its rows
        out = sharding.gather_rows(table, ids.clamp(min=0))
    else:
        out = table.index_select(0, ids.clamp(min=0).reshape(-1)).reshape(
            *ids.shape, table.shape[1])
    return torch.where(valid[..., None], out, out.new_zeros(()))


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,  # (B, L), -1 = padding
    *,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,  # (B, L) per-sample weights
    cfg: Optional[TableConfig] = None,
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function: (B, L) multi-hot -> (B, dim),
    the reference's gather and ``segment_sum`` over the batch rows."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode {mode!r}")
    B, L = ids.shape
    emb = lookup(table, ids, cfg)  # (B, L, dim) zeros at padding
    if weights is not None:
        emb = emb * weights[..., None]
    seg = torch.arange(B, device=ids.device).repeat_interleave(L)
    out = emb.new_zeros((B, emb.shape[-1])).index_add_(0, seg, emb.reshape(B * L, -1))
    if mode == "mean":
        cnt = (ids >= 0).sum(dim=1, keepdim=True).to(out.dtype)
        out = out / cnt.clamp(min=1.0)
    return out
