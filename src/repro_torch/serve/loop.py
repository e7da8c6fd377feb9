"""Instrumented serving loop: continuous query batching over an OnlineIndex
(counterpart of ``repro.serve.loop``).

  * **arrival queue and power-of-two coalescing** — queries arrive one by
    one or in bursts (``submit``); each ``step`` drains up to ``max_batch``
    of them and pads the wave to the next power of two;
  * **churn between waves** — writes (``add``/``remove``) ride the index's
    buffer and are flushed before the next wave's search;
  * **latency** — per query, from enqueue to the result's ids on the host:
    the clock stops only after ``.cpu()`` of the ids, so it covers queueing
    and the card's work;
  * **recall reservoir** — every ``recall_sample_every``-th served query
    (its vector and the ids served) is kept in a round-robin reservoir;
    ``audit_recall`` scores a fresh search of them, and the served ids,
    against brute force over the live catalog;
  * **telemetry** — each wave folds its ``SearchResult`` into a
    ``SearchStats`` after the ids are on the host, and ``report()`` logs
    p50/p99/QPS through the tracker.

The loop is a synchronous host-side state machine.  Entry points come from
a ``torch.Generator`` seeded with ``seed``, or from ``seed_fn(B, n_valid)``
(see ``index.lifecycle``), called once per search in order.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import brute
from repro_torch.index.lifecycle import OnlineIndex, SearchSeedFn
from repro_torch.obs import NOOP, SearchStats, Tracker

__all__ = ["ServeLoopConfig", "ServingLoop"]


@dataclasses.dataclass(frozen=True)
class ServeLoopConfig:
    """``max_batch`` is the largest coalescing bucket (a power of two);
    ``recall_sample_every`` is a deterministic stride."""

    top_k: int = 10
    beam: Optional[int] = None  # None -> the index's default (2*top_k)
    max_batch: int = 64  # pow2 coalescing cap per query wave
    recall_reservoir: int = 64  # audited-query slots (round-robin overwrite)
    recall_sample_every: int = 7  # stride between sampled queries

    def __post_init__(self):
        if self.max_batch < 1 or self.max_batch & (self.max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, got {self.max_batch}")
        if self.recall_sample_every < 1 or self.recall_reservoir < 1:
            raise ValueError("recall_sample_every and recall_reservoir must be >= 1")


class ServingLoop:
    """Query/churn front end over one ``OnlineIndex`` (see module doc)."""

    def __init__(
        self,
        index: OnlineIndex,
        cfg: ServeLoopConfig = ServeLoopConfig(),
        tracker: Optional[Tracker] = None,
        seed: int = 0,
        seed_fn: Optional[SearchSeedFn] = None,
    ):
        self.index = index
        self.cfg = cfg
        self.tracker = tracker or NOOP
        # the index reports its lifecycle spans through the same tracker
        if tracker is not None and index.tracker is None:
            index.tracker = tracker
        self.stats = SearchStats(n_items=index.n_items)
        self._queue: deque = deque()  # (query row np (d,), t_enqueue)
        self._gen = torch.Generator(device=index.device).manual_seed(seed)
        self._seed_fn = seed_fn
        self._wave_idx = 0
        self._served = 0
        self._lat: List[float] = []  # per-query enqueue -> ids-on-host seconds
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._res_q: List[np.ndarray] = []
        self._res_ids: List[np.ndarray] = []
        self._sample_count = 0

    # -- ingress -------------------------------------------------------------

    def submit(self, queries) -> int:
        """Enqueue one query (1-D) or a burst (2-D); returns queue depth."""
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        now = time.perf_counter()
        for row in q:
            self._queue.append((row, now))
        return len(self._queue)

    def add(self, items, *, seed_fn=None) -> None:
        """Catalog insert, buffered until the next wave boundary."""
        with self.tracker.span("serve/add"):
            self.index.add(items, seed_fn=seed_fn, flush=False)

    def remove(self, ids) -> None:
        """Catalog withdrawal (flushes buffered adds first, like the index)."""
        with self.tracker.span("serve/remove") as sp:
            self.index.remove(ids)
            sp.sync(self.index.graph.alive)

    # -- the wave ------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def served(self) -> int:
        return self._served

    def _search(self, q: np.ndarray):
        return self.index.search(
            torch.from_numpy(q), self.cfg.top_k, beam=self.cfg.beam,
            seed_fn=self._seed_fn, generator=self._gen,
        )

    def step(self) -> Optional[dict]:
        """Serve one coalesced wave; returns a per-wave summary (None if the
        queue was empty): flush pending writes, drain up to ``max_batch``
        queries, pad to the pow2 bucket, search, read the ids, stamp
        latencies, fold stats, feed the reservoir."""
        if not self._queue:
            return None
        cfg = self.cfg
        t_wave0 = time.perf_counter()
        if self._t_first is None:
            self._t_first = t_wave0

        with self.tracker.span("serve/step") as step_sp:
            if self.index.n_pending:
                self.index.flush()
            m = min(len(self._queue), cfg.max_batch)
            rows, t_enq = zip(*(self._queue.popleft() for _ in range(m)))
            P = 1 << (m - 1).bit_length()
            batch = np.empty((P, rows[0].shape[0]), np.float32)
            batch[:m] = np.stack(rows)
            batch[m:] = rows[-1]  # pad with a real row
            n_live = self.index.n_items

            with self.tracker.span("serve/search") as sp:
                res = self._search(batch)
                # the answers go to the caller: this read is the wave's own
                # sync, tracker or not, and the clock stops after it
                ids = res.ids.cpu().numpy()[:m]
                sp.synced = True
            t_done = time.perf_counter()
            step_sp.synced = True
            self._lat.extend(t_done - t for t in t_enq)
            self._served += m
            self._t_last = t_done
            self.stats.update(_slice_result(res, m), n_items=n_live)
            for i in range(m):
                c = self._sample_count
                self._sample_count += 1
                if c % cfg.recall_sample_every:
                    continue
                slot = (c // cfg.recall_sample_every) % cfg.recall_reservoir
                if slot < len(self._res_q):
                    self._res_q[slot] = batch[i]
                    self._res_ids[slot] = ids[i]
                else:
                    self._res_q.append(batch[i])
                    self._res_ids.append(ids[i])

        self._wave_idx += 1
        wave = {
            "wave": self._wave_idx,
            "batch": m,
            "bucket": P,
            "latency_s": t_done - t_wave0,
            "queue_depth": len(self._queue),
        }
        self.tracker.log_metrics(
            {f"serve/{k}": v for k, v in wave.items() if k != "wave"}, step=self._wave_idx
        )
        return wave

    def pump(self) -> int:
        """Drain the queue; returns the number of waves served."""
        waves = 0
        while self._queue:
            self.step()
            waves += 1
        return waves

    # -- audits + reporting --------------------------------------------------

    def audit_recall(self, k: int = 10) -> dict:
        """Brute-force the reservoir against the live index: ``recall_at_k``
        of a fresh search of each sampled query, and ``recall_at_k_served``
        of the ids served at sample time (which churn may have removed)."""
        if not self._res_q:
            return {"n_audited": 0}
        with self.tracker.span("serve/audit") as sp:
            q = np.stack(self._res_q)
            self.index.flush()
            true_ids, _ = brute.brute_force_knn(
                self.index.items, torch.from_numpy(q).to(self.index.device), k,
                self.index.metric, n_valid=self.index.graph.n_valid,
                alive=self.index.graph.alive, device=self.index.device,
            )
            fresh = self._search(q)
            sp.sync((true_ids, fresh.ids))
            fresh_rec = brute.recall_at_k(fresh.ids, true_ids, k)
            served = torch.from_numpy(np.stack(self._res_ids)).to(true_ids.device)
            served_rec = brute.recall_at_k(served, true_ids, k)
        out = {
            "n_audited": len(self._res_q),
            f"recall_at_{k}": fresh_rec,
            f"recall_at_{k}_served": served_rec,
        }
        self.tracker.log_metrics({f"serve/{kk}": v for kk, v in out.items()})
        return out

    def report(self, audit_k: int = 10) -> dict:
        """The sustained-load record: p50/p99 latency, QPS, scanning rate,
        hash saturation and the audited recall."""
        lat = np.asarray(self._lat, np.float64)
        span_s = (
            self._t_last - self._t_first
            if self._t_first is not None and self._t_last is not None else 0.0
        )
        rec = {
            "n_served": self._served,
            "n_waves": self._wave_idx,
            "qps": self._served / span_s if span_s > 0 else 0.0,
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "p99_latency_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else 0.0,
            "mean_latency_ms": float(lat.mean() * 1e3) if lat.size else 0.0,
            "comps_per_query": self.stats.comps_per_query,
            "scanning_rate": self.stats.scanning_rate,
            "hash_saturation_ratio": self.stats.hash_saturation_ratio,
            "capped_ratio": self.stats.capped_ratio,
        }
        if self._res_q:
            rec.update(self.audit_recall(k=audit_k))
        self.tracker.log_metrics({f"serve/{k}": v for k, v in rec.items()})
        return rec

    def reset_window(self) -> None:
        """Start a fresh measurement window (latency, stats, reservoir, wave
        clock) without touching the index or the queue."""
        self.stats.reset()
        self._lat = []
        self._served = 0
        self._wave_idx = 0
        self._t_first = None
        self._t_last = None
        self._res_q, self._res_ids = [], []
        self._sample_count = 0


def _slice_result(res, m: int):
    """The first m lanes of a padded wave's ``SearchResult`` (padding lanes
    repeat a real query and must not be counted twice)."""
    return res._replace(**{name: getattr(res, name)[:m] for name in res._fields})
