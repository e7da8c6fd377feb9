"""Closed-loop exact k-NN: one caller, each call a block of held-out queries
against every row through ``core.brute.brute_force_knn`` (the pairwise
kernel's tiles and a running top-k), timed from submit to the ids on the
host.  No graph and no EHC loop.

Traffic parameters: ``queries_per_call``, ``pool_blocks``, ``query_set``
(as for ``ann_batch``), ``top_k``, ``warmup_calls``.  Every answer of the window is held against the exact
top-k.
"""

from __future__ import annotations

import torch

from cardbench import data, faults
from cardbench.reference import checks, exact


class Exact:
    def __init__(self, ctx):
        self.ctx = ctx
        self.kept = []
        self._last = None

    def setup(self):
        ctx, cfg, tr = self.ctx, self.ctx.cfg, self.ctx.traffic
        self.x = data.catalog(cfg, ctx.device)
        B = tr["queries_per_call"]
        qseed = data.query_seed(cfg, tr, ctx.seed)
        self.pool = list(data.queries(cfg, qseed, tr["pool_blocks"] * B, ctx.device).split(B))
        # the control hands the program bf16 rows and queries: its bf16
        # pairwise path
        cast = (lambda t: t.bfloat16()) if ctx.control else (lambda t: t)
        self.x_in = cast(self.x)
        self.pool_in = [cast(q) for q in self.pool]
        for _ in range(tr["warmup_calls"]):
            self._search(0)

    def _search(self, b):
        from repro_torch.core.brute import brute_force_knn

        tr, cfg = self.ctx.traffic, self.ctx.cfg
        ids, dists = brute_force_knn(self.x_in, self.pool_in[b], tr["top_k"], cfg["build"]["metric"],
                                     device=self.ctx.device)
        return ids.cpu(), dists

    def call(self, i: int) -> int:
        b = i % len(self.pool)
        with torch.profiler.record_function("cardbench/brute_force_knn"):
            ids, dists = self._search(b)
        self._last = (b, ids, dists)
        return ids.shape[0]

    def keep(self, traced: bool) -> None:
        b, ids, dists = self._last
        self.kept.append({"block": b, "ids": ids, "dists": dists})
        self._last = None

    def call_stats(self) -> list:
        return [{"queries": int(k["ids"].shape[0])} for k in self.kept]

    def release(self) -> None:
        self.x_in = self.pool_in = None

    def check(self) -> dict:
        cfg, tr = self.ctx.cfg, self.ctx.traffic
        x, metric, k = self.x, cfg["build"]["metric"], tr["top_k"]
        truth = [exact.knn(x, q, k, metric)[1] for q in self.pool]
        bad, short, answers, err, gap = 0, 0, 0, 0.0, 0.0
        for kept in self.kept:
            q, ids = self.pool[kept["block"]], kept["ids"].to(x.device)
            bad += checks.bad_rows(ids, kept["dists"], x.shape[0])
            short += checks.short_rows(ids, min(k, x.shape[0]))
            answers += ids.shape[0]
            err = max(err, checks.dist_err(x, q, ids, kept["dists"], metric))
            gap = max(gap, checks.rank_gap(x, q, ids, truth[kept["block"]], metric))
        return {"bad_answers": bad, "short_answers": short / max(1, answers), "dist_err": err,
                "rank_gap": gap}


Driver = Exact


def plant(fault: str, undo: list) -> None:
    """Plant ``fault`` under ``brute_force_knn``: the running top-k keeps
    its state (``ops.tile_topk``, which every tile calls), or the answers
    are halved or altered."""
    import repro_torch.core.brute as brute

    if fault == "unchanged_state":
        faults.swap(brute.ops, "tile_topk", lambda dt, best_d, best_i, *a, **kw: (best_d, best_i),
                    undo)
        return
    change = faults.halve if fault == "half_batch" else faults.alter
    real = brute.brute_force_knn

    def faulty_brute(*a, **kw):
        return change(*real(*a, **kw))
    faults.swap(brute, "brute_force_knn", faulty_brute, undo)
