"""OnlineIndex: the index's life outside a single build call (counterpart of
``repro.index.lifecycle``).

  * **growth** — an insert past capacity grows graph and data to
    ``growth_factor * capacity`` (amortized doubling) instead of failing;
  * **free-slot ledger** — ``remove`` records its victims; before growing,
    an insert first reclaims them through ``compact()`` (``auto_compact``),
    so steady churn runs at a fixed capacity;
  * **compact()** — re-packs the alive rows (``dynamic.compact``) and keeps
    the old -> new row map for callers holding row ids;
  * **micro-batched ingest** — ``add(..., flush=False)`` buffers rows on the
    host and coalesces them into one insertion (``dynamic.insert``) once
    ``ingest_batch`` rows wait; a search flushes first, so reads observe
    prior writes;
  * **snapshots** — ``save``/``load`` through ``index.snapshot``.

The index lives on one device (its tensors').  Every mutation assigns new
tensors and never writes into a tensor it holds, so ``clone()`` shares
tensors between copies safely (copy-on-write); the functional entry points
of ``serve.retrieval`` rely on it.

Entry points are drawn from ``torch.Generator``s unless injected: a
wave-shaped ``seed_fn(wave, pos, W, n_valid)`` for insertions (as in
``construct.build``), and a search-shaped ``seed_fn(B, n_valid)`` for
searches, either returning the (B, p) seeds or, under coarse seeding, the
pair (seeds, landmark seeds of the coarse pass).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import construct, dynamic, hierarchy
from repro_torch.core import graph as graph_lib
from repro_torch.core import search as search_lib
from repro_torch.core.graph import KNNGraph
from repro_torch.index import snapshot as snapshot_lib
from repro_torch.kernels import precision as precision_lib
from repro_torch.obs import NOOP

# seed_fn(B, n_valid) -> (B, p) seeds, or (seeds, (B, p) coarse-pass seeds)
SearchSeedFn = Callable[[int, int], object]


@dataclasses.dataclass
class OnlineIndex:
    """A long-lived online k-NN index: graph + data + config + churn state."""

    graph: KNNGraph
    items: torch.Tensor  # (capacity, d) float32 or bfloat16; rows beyond n_valid are free
    build_cfg: construct.BuildConfig
    coarse: Optional[hierarchy.CoarseLevel] = None  # under seed_mode="coarse"
    free_ids: tuple = ()  # ledger of removed rows < n_valid
    pending: tuple = ()  # buffered adds: (m_i, d) tensors
    ingest_batch: int = 64  # coalesce threshold for buffered adds
    auto_compact: bool = True  # reclaim free slots before growing
    growth_factor: float = 2.0
    last_compact_map: Optional[np.ndarray] = None  # old -> new rows, last compact
    pending_seed_fn: Optional[construct.SeedFn] = None  # stashed by buffered adds
    pq_codebook: Optional[torch.Tensor] = None  # pinned PQ code space
    tracker: object = None  # obs.Tracker for lifecycle spans (None: none)
    _enc: object = None  # cached compressed serving table
    _ledger_synced: bool = False  # reconciliation ran (clones inherit it)

    def __post_init__(self):
        # the alive mask is the ground truth; a graph that arrives with dead
        # rows and no ledger reconciles here, once per lineage
        if not self._ledger_synced:
            if not self.free_ids:
                dead = torch.nonzero(~self.graph.alive[: self.graph.n_valid])[:, 0]
                self.free_ids = tuple(int(i) for i in dead.tolist())
            self._ledger_synced = True

    # -- views ---------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.items.device

    @property
    def metric(self) -> str:
        return self.build_cfg.metric

    @property
    def capacity(self) -> int:
        return self.graph.capacity

    @property
    def n_pending(self) -> int:
        return sum(int(p.shape[0]) for p in self.pending)

    @property
    def free_slots(self) -> int:
        return len(self.free_ids)

    @property
    def n_items(self) -> int:
        """Live catalog size: allocated − removed + buffered."""
        return self.graph.n_valid - len(self.free_ids) + self.n_pending

    def clone(self) -> "OnlineIndex":
        """A copy sharing every tensor (mutations replace, never write)."""
        return dataclasses.replace(self)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        items: torch.Tensor,
        cfg: Optional[construct.BuildConfig] = None,
        *,
        capacity: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        seed_fn: Optional[construct.SeedFn] = None,
        landmark_rows: Optional[torch.Tensor] = None,
        landmark_seed_fn: Optional[construct.SeedFn] = None,
        ingest_batch: int = 64,
        auto_compact: bool = True,
        growth_factor: float = 2.0,
        device=None,
        **cfg_kw,
    ) -> "OnlineIndex":
        """Index ``items`` with the online build; ``capacity > n``
        pre-allocates headroom.  Entry points from ``seed_fn``, else from
        ``generator`` (default: seeded 0)."""
        if cfg is None:
            cfg = construct.BuildConfig(**cfg_kw)
        elif cfg_kw:
            raise ValueError(
                f"pass either cfg or BuildConfig kwargs, not both (got cfg and {sorted(cfg_kw)})"
            )
        dev = device_lib.resolve(device)
        items = construct.stored_data(torch.as_tensor(items), cfg, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        n = items.shape[0]
        cap = capacity or n
        g, _, coarse = construct.build(
            items, cfg, generator=generator, seed_fn=seed_fn, return_coarse=True,
            landmark_rows=landmark_rows, landmark_seed_fn=landmark_seed_fn, device=dev,
        )
        if cap > n:
            g = graph_lib.grow_graph(g, cap)
            items = torch.cat([items, items.new_zeros((cap - n, items.shape[1]))])
        return cls(
            graph=g, items=items, build_cfg=cfg, coarse=coarse, ingest_batch=ingest_batch,
            auto_compact=auto_compact, growth_factor=growth_factor,
        )

    # -- churn ---------------------------------------------------------------

    def add(
        self,
        new_items,
        *,
        seed_fn: Optional[construct.SeedFn] = None,
        flush: Optional[bool] = None,
    ) -> "OnlineIndex":
        """Insert rows.  ``flush=False`` only buffers, ``True`` inserts now;
        the default flushes once ``ingest_batch`` rows wait.  A ``seed_fn``
        given with a buffered add is kept for the flush that inserts it.
        Returns self (mutates in place)."""
        # buffered in the items' dtype (bfloat16 under data_bf16)
        new_items = torch.as_tensor(new_items).to(self.device, self.items.dtype).clone()
        if new_items.dim() == 1:
            new_items = new_items[None, :]
        if new_items.shape[0]:
            self.pending = self.pending + (new_items,)
            if seed_fn is not None:
                self.pending_seed_fn = seed_fn
        do_flush = flush if flush is not None else self.n_pending >= self.ingest_batch
        if do_flush:
            self.flush(seed_fn=seed_fn)
        return self

    def flush(self, *, seed_fn: Optional[construct.SeedFn] = None) -> "OnlineIndex":
        """Coalesce the buffered adds into one insertion.  Every exit
        clears the stashed ``seed_fn``."""
        if not self.pending:
            self.pending_seed_fn = None
            return self
        if seed_fn is None:
            seed_fn = self.pending_seed_fn
        trk = self.tracker or NOOP
        with trk.span("index/flush") as sp:
            batch = torch.cat(self.pending)
            m = batch.shape[0]
            self._ensure_room(m)
            n0 = self.graph.n_valid
            items = torch.cat([self.items[:n0], batch, self.items[n0 + m:]])
            out = dynamic.insert(
                self.graph, items, m, self.build_cfg, seed_fn=seed_fn,
                coarse=self.coarse, device=self.device,
            )
            if len(out) == 3:
                g, _, self.coarse = out
            else:
                g, _ = out
            self.graph, self.items = g, items
            self._enc = None  # the compressed serving table re-derives lazily
            # drained only after the rows landed: a failure above keeps them
            self.pending = ()
            self.pending_seed_fn = None
            sp.sync(self.graph.nbr_ids)
        trk.log_metrics({
            "index/flushed": m,
            "index/n_items": self.n_items,
            "index/ledger_depth": self.free_slots,
            "index/capacity": self.capacity,
        })
        return self

    def remove(self, ids) -> "OnlineIndex":
        """Remove rows; the victims enter the free-slot ledger.  Flushes
        buffered adds first; if that flush compacted, the caller's
        (pre-flush) row ids are remapped through the compaction map.  Only
        in-range, alive ids act (-1 padding and stale ids are no-ops)."""
        pre_map = self.last_compact_map
        self.flush()
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids_np = np.unique(np.asarray(ids).reshape(-1).astype(np.int64))
        if self.last_compact_map is not pre_map:
            id_map = self.last_compact_map
            ok = (ids_np >= 0) & (ids_np < len(id_map))
            ids_np = id_map[ids_np[ok]].astype(np.int64)
        alive = self.graph.alive.cpu().numpy()
        ids_np = ids_np[(ids_np >= 0) & (ids_np < alive.shape[0])]
        newly_dead = ids_np[alive[ids_np]]
        if not newly_dead.size:
            return self
        trk = self.tracker or NOOP
        with trk.span("index/remove") as sp:
            dead = torch.from_numpy(newly_dead).to(self.device)
            self.graph = dynamic.remove(self.graph, self.items, dead, self.metric)
            if self.coarse is not None:
                removed = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
                removed[dead] = True
                self.coarse = hierarchy.purge_rows(self.coarse, removed)
            self.free_ids = self.free_ids + tuple(int(i) for i in newly_dead)
            self._enc = None  # the victims' rows leave the table
            sp.sync(self.graph.alive)
        trk.log_metrics({
            "index/removed": int(newly_dead.size),
            "index/n_items": self.n_items,
            "index/ledger_depth": self.free_slots,
        })
        return self

    def compact(self) -> np.ndarray:
        """Re-pack the alive rows to the front, reclaiming the ledger's
        slots.  Returns the (capacity,) old -> new row map (-1 for removed
        rows), also kept as ``last_compact_map``."""
        trk = self.tracker or NOOP
        with trk.span("index/compact") as sp:
            reclaimed = len(self.free_ids)
            g, x, id_map = dynamic.compact(self.graph, self.items)
            self.graph, self.items = g, x
            if self.coarse is not None:
                self.coarse = hierarchy.remap_rows(self.coarse, id_map)
            self.free_ids = ()
            self.last_compact_map = id_map.cpu().numpy()  # a host sync
            self._enc = None
            sp.synced = True
        trk.log_metrics({
            "index/compact_reclaimed": reclaimed,
            "index/n_items": self.n_items,
            "index/capacity": self.capacity,
        })
        return self.last_compact_map

    def _ensure_room(self, m: int) -> None:
        """Make room for m tail inserts: recycle free slots, then grow."""
        if m <= self.capacity - self.graph.n_valid:
            return
        if self.auto_compact and self.free_ids:
            if self.graph.n_valid - len(self.free_ids) + m <= self.capacity:
                self.compact()
                return
        old_cap = self.capacity
        new_cap = max(self.graph.n_valid + m, int(self.capacity * self.growth_factor), 1)
        self.graph = graph_lib.grow_graph(self.graph, new_cap)
        self.items = torch.cat(
            [self.items, self.items.new_zeros((new_cap - self.items.shape[0], self.items.shape[1]))]
        )
        (self.tracker or NOOP).log_metrics({"index/grow_from": old_cap, "index/grow_to": new_cap})

    # -- search --------------------------------------------------------------

    def search_config(self, top_k: int, beam: Optional[int] = None) -> search_lib.SearchConfig:
        """The build's search parameters with the request's k and beam."""
        return dataclasses.replace(
            self.build_cfg.search_config(), k=top_k, beam=max(beam or 2 * top_k, top_k)
        )

    def _ensure_coarse(self, **derive_kw):
        """Derive the coarse level when coarse seeding wants one and none is
        attached (``derive_kw`` go to ``hierarchy.derive_coarse``; its
        landmarks default to a generator seeded with ``n_valid``)."""
        if self.coarse is None and self.build_cfg.seed_mode == "coarse":
            if self.graph.n_valid - len(self.free_ids) > 0:
                derive_kw.setdefault("generator", self._generator(self.graph.n_valid))
                self.coarse = hierarchy.derive_coarse(
                    self.graph, self.items, self.build_cfg, device=self.device, **derive_kw
                )
        return self.coarse

    def _ensure_enc(self):
        """The compressed serving table of a non-fp32 build, encoded once
        after each mutation; int8 reuses the graph's scale cache, and a PQ
        codebook is trained once and pinned."""
        precision = self.build_cfg.precision
        if precision == "fp32":
            return None
        if self._enc is None:
            self._enc = precision_lib.encode_dataset(
                self.items, precision,
                row_scale=self.graph.row_scale if precision == "int8" else None,
                codebook=self.pq_codebook if precision == "pq" else None,
            )
            if precision == "pq" and self.pq_codebook is None:
                self.pq_codebook = self._enc.codebook
        return self._enc

    def search(
        self,
        queries,
        top_k: int,
        *,
        beam: Optional[int] = None,
        seed_fn: Optional[SearchSeedFn] = None,
        generator: Optional[torch.Generator] = None,
    ) -> search_lib.SearchResult:
        """EHC search of (B, d) queries (flushes buffered adds first).
        Entry points from ``seed_fn(B, n_valid)``, called after the flush,
        else from ``generator`` (default: seeded 0).  The call is the
        ``index/search`` span, and the search's own spans nest in it."""
        with (self.tracker or NOOP).span("index/search"):
            self.flush()
            q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
            scfg = self.search_config(top_k, beam)
            coarse = None
            if scfg.seed_mode == "coarse":
                coarse = self._ensure_coarse()
                if coarse is None:  # nothing alive to derive from
                    scfg = dataclasses.replace(scfg, seed_mode="random")
            seeds = coarse_seeds = None
            if seed_fn is not None:
                out = seed_fn(q.shape[0], self.graph.n_valid)
                seeds, coarse_seeds = out if isinstance(out, tuple) else (out, None)
            elif generator is None:
                generator = self._generator(0)
            return search_lib.search(
                self.graph, self.items, q, scfg, seeds=seeds, coarse_seeds=coarse_seeds,
                generator=generator, coarse=coarse, enc=self._ensure_enc(), device=self.device,
                tracker=self.tracker,
            )

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Snapshot graph + data + config + coarse level + PQ codebook
        (flushes buffered adds first)."""
        self.flush()
        return snapshot_lib.save(
            path, self.graph, self.items, self.build_cfg, coarse=self.coarse,
            pq_codebook=self.pq_codebook,
            extra_meta={"free_ids": [int(i) for i in self.free_ids]},
        )

    @classmethod
    def load(cls, path: str, *, device=None, **lifecycle_kw) -> "OnlineIndex":
        """Restore a saved index; a coarse level missing under
        ``seed_mode="coarse"`` is re-derived here."""
        g, items, cfg, manifest, coarse, pq_cb = snapshot_lib.load(
            path, with_coarse=True, with_pq_codebook=True, device=device
        )
        free = tuple(manifest.get("extra", {}).get("free_ids", []))
        idx = cls(graph=g, items=items, build_cfg=cfg, coarse=coarse, free_ids=free,
                  pq_codebook=pq_cb, **lifecycle_kw)
        if coarse is None and cfg.seed_mode == "coarse":
            idx._ensure_coarse()
        return idx
