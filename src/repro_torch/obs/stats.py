"""SearchStats: fold per-query search signals into serving telemetry
(counterpart of ``repro.obs.stats``).

Every ``SearchResult`` carries exact per-lane accounting — ``n_comps``,
``hash_full``, ``n_iters`` and ``converged``.  ``SearchStats`` is the
host-side aggregator: fed results at existing sync boundaries, it keeps

  * total/mean/max comparisons per query;
  * the serving **scanning rate** — Eq. 2 extended to reads: mean distance
    evaluations per query over the live catalog size;
  * the **hash-saturation ratio** — share of queries whose ``hash_full``
    flag fired;
  * the share of lanes stopped by the ``max_iters`` cap.

``update`` copies its tensors to the host, so it is itself a sync: callers
place it where a sync already exists (the serving loop has read the ids by
then).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["SearchStats"]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class SearchStats:
    """Running aggregate over many ``SearchResult`` batches (see module doc).

    ``n_items`` may be pinned at construction or passed per ``update`` (a
    churning catalog changes size); the scanning rate uses the comps-weighted
    live size so interleaved churn stays honest.
    """

    def __init__(self, n_items: Optional[int] = None):
        self.default_n_items = n_items
        self.n_queries = 0
        self.total_comps = 0
        self.total_iters = 0
        self.hash_full_queries = 0
        self.capped_queries = 0  # stopped by max_iters, not convergence
        self.max_comps = 0
        # sum over queries of (live catalog size at serve time): the scanning
        # rate denominator under churn is the mean catalog each query saw
        self._n_items_weighted = 0

    # -- folding -------------------------------------------------------------

    def update(self, res, n_items: Optional[int] = None) -> "SearchStats":
        """Fold one batch's ``SearchResult`` (or any object with ``n_comps``,
        ``hash_full``, ``n_iters``, ``converged`` per-lane arrays).  This is
        a host sync — call it only at existing sync boundaries."""
        comps = _host(res.n_comps).reshape(-1).astype(np.int64)
        full = _host(res.hash_full).reshape(-1)
        iters = _host(res.n_iters).reshape(-1).astype(np.int64)
        conv = _host(res.converged).reshape(-1)
        B = comps.shape[0]
        n_live = self.default_n_items if n_items is None else int(n_items)

        self.n_queries += B
        self.total_comps += int(comps.sum())
        self.total_iters += int(iters.sum())
        self.hash_full_queries += int(np.count_nonzero(full))
        self.capped_queries += int(np.count_nonzero(~conv))
        if B:
            self.max_comps = max(self.max_comps, int(comps.max()))
        if n_live is not None:
            self._n_items_weighted += B * int(n_live)
        return self

    def merge(self, other: "SearchStats") -> "SearchStats":
        """Fold another aggregator in (per-shard stats -> router totals)."""
        self.n_queries += other.n_queries
        self.total_comps += other.total_comps
        self.total_iters += other.total_iters
        self.hash_full_queries += other.hash_full_queries
        self.capped_queries += other.capped_queries
        self.max_comps = max(self.max_comps, other.max_comps)
        self._n_items_weighted += other._n_items_weighted
        return self

    def reset(self) -> None:
        """Zero every accumulator (warm-up rounds are folded then reset)."""
        self.__init__(self.default_n_items)

    # -- derived views -------------------------------------------------------

    @property
    def comps_per_query(self) -> float:
        return self.total_comps / max(self.n_queries, 1)

    @property
    def scanning_rate(self) -> float:
        """Serving Eq.-2: mean comps per query over the mean live catalog
        size those queries were served against (0 when size is unknown)."""
        if self._n_items_weighted == 0:
            return 0.0
        return self.total_comps / self._n_items_weighted

    @property
    def hash_saturation_ratio(self) -> float:
        return self.hash_full_queries / max(self.n_queries, 1)

    @property
    def capped_ratio(self) -> float:
        return self.capped_queries / max(self.n_queries, 1)

    def __repr__(self) -> str:
        return (
            f"SearchStats(n_queries={self.n_queries}, "
            f"comps/q={self.comps_per_query:.1f}, "
            f"scan={self.scanning_rate:.5f}, "
            f"hash_sat={self.hash_saturation_ratio:.3f})"
        )
