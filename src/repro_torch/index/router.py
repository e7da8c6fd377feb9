"""Sharded serving router: one logical index over S ``OnlineIndex`` shards
(counterpart of ``repro.index.router``).

* **queries** fan out to every shard and merge by distance: under per-shard
  brute force the merged top-k is the unsharded top-k;
* **inserts** go to the shard with the fewest live items;
* **removals** go to the owner: the router owns the global id space and
  keeps, per shard, a local-row -> global-id table (numpy int64, -1 for a
  free row) that follows every compaction and growth of the shard.

Global ids are the rows of the catalog the router was built from, then
consecutive for each insert, and stay valid for the router's life.
``merge_shards`` collapses the shards into one index by the
divide-and-conquer merge (``merge.merge_subgraphs`` + ``nndescent.refine``).
Snapshots use the reference's layout, so either package loads the other's.

Entry points come from a ``core.draws.Draws`` (default ``TorchDraws(0)``)
along the reference's chain: shard s builds and is searched from
``fold_in(s)``, and ``merge_shards`` keys its merge tree with ``draws``
itself.  Inserts take a build-shaped ``seed_fn`` as ``OnlineIndex.add``
does.  Mutations replace the tables and the shards' tensors, never writing
into one they hold.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import construct
from repro_torch.core import draws as draws_lib
from repro_torch.index.lifecycle import OnlineIndex

_MANIFEST = "router.json"
_LIFECYCLE_KW = ("capacity", "ingest_batch", "auto_compact", "growth_factor")


class ShardedIndex:
    """S ``OnlineIndex`` shards serving one logical catalog."""

    def __init__(self, shards: list, gids: list, next_gid: int, tracker=None):
        self.shards: list[OnlineIndex] = shards
        # per shard: (shard capacity,) int64, local row -> global id (-1 free)
        self.gids: list[np.ndarray] = [np.asarray(g, np.int64) for g in gids]
        self.next_gid = int(next_gid)
        # one tracker for the router and its shards: the shards' lifecycle
        # spans nest under the router's fan-out spans
        self.tracker = tracker
        if tracker is not None:
            for sh in self.shards:
                if sh.tracker is None:
                    sh.tracker = tracker

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        items,
        n_shards: int,
        cfg: Optional[construct.BuildConfig] = None,
        *,
        draws=None,
        device=None,
        **build_kw,
    ) -> "ShardedIndex":
        """Partition ``items`` into contiguous blocks and build each shard
        (``build_kw``: ``OnlineIndex.build``'s lifecycle options, or
        ``BuildConfig`` fields when ``cfg`` is None).  Global ids are the
        rows of ``items``.  ``device``: where to run (None: the card)."""
        dev = device_lib.resolve(device)
        items = torch.as_tensor(items).to(device=dev, dtype=torch.float32)
        n = items.shape[0]
        if not 1 <= n_shards <= n:
            raise ValueError(f"need 1 <= n_shards <= n, got {n_shards} for n={n}")
        life = {k: build_kw.pop(k) for k in _LIFECYCLE_KW if k in build_kw}
        if cfg is None:
            cfg = construct.BuildConfig(**build_kw)
        elif build_kw:
            raise ValueError(
                f"pass either cfg or BuildConfig kwargs, not both (got cfg and {sorted(build_kw)})")
        draws = draws_lib.TorchDraws(0) if draws is None else draws
        bounds = construct.partition_bounds(n, n_shards)
        shards, gids = [], []
        for s in range(n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            shard = OnlineIndex.build(
                items[lo:hi], cfg, device=dev,
                **draws_lib.build_kw(draws.fold_in(s), hi - lo, cfg, dev), **life)
            table = np.full(shard.capacity, -1, np.int64)
            table[: hi - lo] = np.arange(lo, hi)
            shards.append(shard)
            gids.append(table)
        return cls(shards, gids, next_gid=n)

    # -- views ---------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_items(self) -> int:
        return sum(s.n_items for s in self.shards)

    @property
    def metric(self) -> str:
        return self.shards[0].metric

    # -- shard-table maintenance ---------------------------------------------

    def _sync_table(self, s: int) -> None:
        """Follow shard s's row moves: its last compaction, then growth."""
        shard = self.shards[s]
        table = self.gids[s]
        if shard.last_compact_map is not None:
            id_map = shard.last_compact_map  # old row -> new row
            new_table = np.full(max(len(id_map), shard.capacity), -1, np.int64)
            moved = id_map >= 0
            new_table[id_map[moved]] = table[: len(id_map)][moved]
            table = new_table
            shard.last_compact_map = None
        if len(table) < shard.capacity:  # the shard grew
            table = np.concatenate([table, np.full(shard.capacity - len(table), -1, np.int64)])
        self.gids[s] = table

    # -- churn ---------------------------------------------------------------

    def add(self, new_items, *, seed_fn: Optional[construct.SeedFn] = None) -> np.ndarray:
        """Insert rows into the shard with the fewest live items (entry
        points from ``seed_fn``, as ``OnlineIndex.add``).  Returns their
        global ids."""
        new_items = torch.as_tensor(new_items, dtype=torch.float32)
        if new_items.dim() == 1:
            new_items = new_items[None, :]
        m = int(new_items.shape[0])
        if m == 0:
            return np.empty((0,), np.int64)
        s = int(np.argmin([sh.n_items for sh in self.shards]))
        shard = self.shards[s]
        shard.add(new_items, seed_fn=seed_fn, flush=True)
        self._sync_table(s)
        n1 = shard.graph.n_valid
        new_gids = np.arange(self.next_gid, self.next_gid + m, dtype=np.int64)
        table = self.gids[s].copy()
        table[n1 - m:n1] = new_gids
        self.gids[s] = table
        self.next_gid += m
        return new_gids

    def remove(self, global_ids) -> int:
        """Withdraw global ids from their owners (-1, the tables' free-row
        sentinel, and unknown ids are ignored).  Returns the number removed."""
        if isinstance(global_ids, torch.Tensor):
            global_ids = global_ids.cpu().numpy()
        want = np.unique(np.asarray(global_ids, np.int64))
        want = want[want >= 0]
        removed = 0
        for s, shard in enumerate(self.shards):
            self._sync_table(s)  # local rows must be current before the lookup
            table = self.gids[s]
            local = np.nonzero(np.isin(table, want))[0]
            if not local.size:
                continue
            shard.remove(local)
            table = table.copy()
            table[local] = -1
            self.gids[s] = table
            removed += local.size
        return removed

    def compact(self) -> None:
        """Compact every shard with free rows; the tables follow the moves."""
        for s, shard in enumerate(self.shards):
            if shard.free_slots:
                shard.compact()
                self._sync_table(s)

    # -- shard collapse ------------------------------------------------------

    def merge_shards(self, *, refine_rounds: int = 1, draws=None,
                     search_chunk: int = 512) -> "ShardedIndex":
        """Collapse the router into one ``OnlineIndex`` over the union
        catalog: every shard is flushed and compacted, the shard graphs are
        folded by ``merge.merge_subgraphs`` (keyed by ``draws``, with the
        shards' coarse levels, cross searches in chunks of ``search_chunk``
        rows, the reference's 512 by default) and refined by
        ``nndescent.refine``.  Global ids keep resolving; the build config
        and lifecycle options come from shard 0.  Returns self (mutated,
        like the churn entry points)."""
        from repro_torch.core import graph as graph_lib
        from repro_torch.core import merge as merge_lib
        from repro_torch.core import nndescent

        draws = draws_lib.TorchDraws(0) if draws is None else draws
        for s, shard in enumerate(self.shards):
            shard.flush()
            if shard.free_slots:
                shard.compact()
            self._sync_table(s)
        if self.n_shards == 1:
            return self
        graphs, parts, tables, coarses = [], [], [], []
        for s, shard in enumerate(self.shards):
            nv = shard.graph.n_valid
            if nv == 0:
                continue
            graphs.append(graph_lib.trim_graph(shard.graph, nv))
            parts.append(shard.items[:nv])
            tables.append(self.gids[s][:nv])
            # the shard's level is in its local rows, the id space of the
            # level-0 cross searches (rows are dense after the compaction)
            coarses.append(shard.coarse)
        base = self.shards[0]
        if not graphs:  # an all-empty router collapses to empty shard 0
            self.shards, self.gids = [base], [self.gids[0]]
            return self
        x = torch.cat(parts)
        g, _, coarse = merge_lib.merge_subgraphs(
            graphs, x, base.build_cfg.search_config(), draws, search_chunk=search_chunk,
            coarses=coarses)
        g, _ = nndescent.refine(g, x, base.metric, rounds=refine_rounds)
        merged = OnlineIndex(
            graph=g, items=x, build_cfg=base.build_cfg, coarse=coarse,
            ingest_batch=base.ingest_batch, auto_compact=base.auto_compact,
            growth_factor=base.growth_factor, tracker=self.tracker,
        )
        self.shards = [merged]
        self.gids = [np.concatenate(tables)]
        return self

    # -- serving -------------------------------------------------------------

    def retrieve(
        self,
        interests,
        top_k: int,
        *,
        beam: Optional[int] = None,
        draws=None,
        brute: bool = False,
        with_stats: bool = False,
    ):
        """Fan out to every shard and merge the shards' top-k by distance.

        Returns (global ids (top_k,) int64, scores (top_k,) float32) as
        numpy arrays, scores in the serving convention
        (``serve.retrieval.score_from_dist``), -1 / the +inf score filler
        where fewer than top_k live items answer.  ``brute=True`` serves
        each shard exactly, and the merged answer is then the unsharded
        brute answer.  Each shard's leg runs under its own
        ``router/shard<s>`` span.  ``with_stats=True`` appends an
        ``obs.SearchStats`` over the shards' searches (None under brute)."""
        from repro_torch.obs import NOOP, SearchStats
        from repro_torch.serve import retrieval  # late: serve imports repro_torch.index

        draws = draws_lib.TorchDraws(0) if draws is None else draws
        trk = self.tracker or NOOP
        stats = None if brute else SearchStats()
        all_gids, all_dist = [], []
        for s, shard in enumerate(self.shards):
            with trk.span(f"router/shard{s}") as sp:
                if brute:
                    ids, scores = retrieval.retrieve_brute(shard, interests, top_k)
                else:
                    ids, scores, res = retrieval.retrieve(
                        shard, interests, top_k, beam=beam,
                        seed_fn=_shard_seed_fn(shard, draws.fold_in(s)), with_stats=True)
                    stats.update(res, n_items=shard.n_items)
                ids = ids.cpu().numpy()
                # scores -> distances (the score convention is an involution)
                dist = retrieval.score_from_dist(scores, self.metric).cpu().numpy()
                sp.synced = True  # the host copies are the sync
            # drop -1 padding and the +inf filler a shard with fewer than
            # top_k live items pads with
            ok = (ids >= 0) & np.isfinite(dist)
            all_gids.append(self.gids[s][ids[ok]])
            all_dist.append(dist[ok])
        gids = np.concatenate(all_gids)
        dist = np.concatenate(all_dist)
        order = np.argsort(dist, kind="stable")[:top_k]
        out_ids = np.full(top_k, -1, np.int64)
        out_dist = np.full(top_k, np.inf, np.float32)
        out_ids[: order.size] = gids[order]
        out_dist[: order.size] = dist[order]
        scores = retrieval.score_from_dist(out_dist, self.metric)
        if with_stats:
            return out_ids, scores, stats
        return out_ids, scores

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Snapshot the router: one snapshot per shard and the id tables."""
        os.makedirs(path, exist_ok=True)
        for s, shard in enumerate(self.shards):
            shard.save(os.path.join(path, f"shard_{s:03d}"))
        np.savez(os.path.join(path, "router_tables.npz"),
                 **{f"gids_{s}": t for s, t in enumerate(self.gids)})
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump({"n_shards": self.n_shards, "next_gid": self.next_gid}, f)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str, *, device=None) -> "ShardedIndex":
        """Restore a saved router (``device``: None is the card)."""
        with open(os.path.join(path, _MANIFEST)) as f:
            man = json.load(f)
        with np.load(os.path.join(path, "router_tables.npz")) as z:
            gids = [z[f"gids_{s}"] for s in range(man["n_shards"])]
        shards = [OnlineIndex.load(os.path.join(path, f"shard_{s:03d}"), device=device)
                  for s in range(man["n_shards"])]
        return cls(shards, gids, next_gid=man["next_gid"])


def _shard_seed_fn(shard: OnlineIndex, draws):
    """A shard search's ``seed_fn(B, n_valid)`` drawing from ``draws``, over
    the shard's landmarks too when it seeds coarsely (read after the search
    has derived any missing level)."""
    def seed_fn(B: int, n_valid: int):
        coarse = shard.coarse if shard.build_cfg.seed_mode == "coarse" else None
        return draws_lib.search_entry(draws, B, shard.build_cfg.n_seeds, n_valid,
                                      None if coarse is None else coarse.n_landmarks,
                                      shard.device)
    return seed_fn

