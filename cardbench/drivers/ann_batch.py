"""Closed-loop batch ANN search: one caller, each call a block of held-out
queries through ``OnlineIndex.search``, timed from submit to the ids on
the host.

Set-up restores the configuration's index from its snapshot in the
benchmark's cache (building and saving it on a miss), makes the pool of
query blocks, and warms up at the cell's shape.  The window cycles
through the pool; entry points come from one generator seeded by the run.

Traffic parameters: ``queries_per_call``, ``pool_blocks``, ``query_set``
(``fixed``: the configuration's own held-out query set, drawn from its
``dataset_seed`` as a published set is one file; ``run``: drawn from the
run's seed), ``top_k``, ``beam``, ``warmup_calls``,
``check_queries_per_block`` (queries of each block whose answers are held
against the exact top-k) and ``check_graph_rows`` (rows of the graph whose
lists are held to their form and their float64 distances).
"""

from __future__ import annotations

import dataclasses
import gc
import shutil

import torch

from cardbench import data, faults
from cardbench.reference import checks, exact


class AnnBatch:
    def __init__(self, ctx):
        self.ctx = ctx
        self.kept = []
        self._last = None

    # -- set-up --------------------------------------------------------------

    def _index(self, x):
        from repro_torch.core.construct import BuildConfig
        from repro_torch.index.lifecycle import OnlineIndex

        ctx, cfg = self.ctx, self.ctx.cfg
        build_cfg = BuildConfig(**cfg["build"])
        home = ctx.cache_dir / cfg["name"]
        if ctx.control:  # the program's own bf16 distance engine, build and search
            build_cfg = dataclasses.replace(build_cfg, precision="bf16")
            home = home.with_name(home.name + ".control")
        path = home / ctx.snapshot_key
        if not (path / "manifest.json").exists():
            shutil.rmtree(home, ignore_errors=True)  # one snapshot a configuration
            home.mkdir(parents=True)
            built = OnlineIndex.build(
                x.clone(), build_cfg, generator=data.generator(ctx.device, cfg["dataset_seed"], "build"),
                device=ctx.device)
            built.save(str(path))
            del built
            gc.collect()
        return OnlineIndex.load(str(path), device=ctx.device)

    def setup(self):
        ctx, cfg, tr = self.ctx, self.ctx.cfg, self.ctx.traffic
        dev = ctx.device
        self.x = data.catalog(cfg, dev)
        self.index = self._index(self.x)
        B = tr["queries_per_call"]
        pool = data.queries(cfg, data.query_seed(cfg, tr, ctx.seed), tr["pool_blocks"] * B, dev)
        self.pool = list(pool.split(B))
        self.entry = data.generator(dev, ctx.seed, "entry")
        warm = data.generator(dev, ctx.seed, "warmup")
        for _ in range(tr["warmup_calls"]):
            self.index.search(self.pool[0], tr["top_k"], beam=tr["beam"], generator=warm).ids.cpu()

    # -- the window ----------------------------------------------------------

    def call(self, i: int) -> int:
        tr = self.ctx.traffic
        b = i % len(self.pool)
        with torch.profiler.record_function("cardbench/index.search"):
            res = self.index.search(self.pool[b], tr["top_k"], beam=tr["beam"], generator=self.entry)
            ids = res.ids.cpu()
        self._last = (b, ids, res)
        return ids.shape[0]

    def keep(self, traced: bool) -> None:
        b, ids, res = self._last
        self.kept.append({
            "block": b, "ids": ids, "dists": res.dists.clone(), "iters": res.n_iters,
            "comps": res.n_comps, "fill": (res.vis_ids >= 0).sum() if traced else None,
        })
        self._last = None

    def call_stats(self) -> list:
        return [{
            "queries": int(k["ids"].shape[0]),
            "iters_max": int(k["iters"].max()),
            "iters_sum": int(k["iters"].sum()),
            "comps_sum": int(k["comps"].sum()),
            "fill_sum": None if k["fill"] is None else int(k["fill"]),
        } for k in self.kept]

    # -- after the window ----------------------------------------------------

    def release(self) -> None:
        """Keep the graph rows the check reads, then free the program."""
        g = self.index.graph
        gen = data.generator("cpu", self.ctx.seed, "graph_rows")
        n = g.n_valid
        rows = torch.randperm(n, generator=gen)[: self.ctx.traffic["check_graph_rows"]]
        self.graph_rows = rows.to(self.x.device)
        self.graph_ids = g.nbr_ids[self.graph_rows].clone()
        self.graph_dist = g.nbr_dist[self.graph_rows].clone()
        self.graph_n = n
        del g
        self.index = None
        gc.collect()
        if self.x.is_cuda:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ctx, cfg, tr = self.ctx, self.ctx.cfg, self.ctx.traffic
        x, metric, k = self.x, cfg["build"]["metric"], tr["top_k"]
        n = x.shape[0]
        gen = data.generator("cpu", ctx.seed, "check_queries")
        B = tr["queries_per_call"]
        per_block = min(B, tr["check_queries_per_block"])
        picks = [torch.randperm(B, generator=gen)[:per_block].to(x.device) for _ in self.pool]
        truth = [exact.knn(x, blk[p], k, metric)[0] for blk, p in zip(self.pool, picks)]
        bad, short, answers, err, hits = 0, 0, 0, 0.0, 0.0
        for kept in self.kept:
            blk, ids = kept["block"], kept["ids"].to(x.device)
            bad += checks.bad_rows(ids, kept["dists"], n)
            short += checks.short_rows(ids, min(k, n))
            answers += ids.shape[0]
            err = max(err, checks.dist_err(x, self.pool[blk], ids, kept["dists"], metric))
            hits += checks.recall(ids[picks[blk]], truth[blk], k)
        return {
            "bad_answers": bad,
            "short_answers": short / max(1, answers),
            "dist_err": err,
            "recall_short": 1.0 - hits / max(1, len(self.kept)),
            "graph_bad_rows": checks.bad_rows(self.graph_ids, self.graph_dist, self.graph_n,
                                              self_ids=self.graph_rows),
            "graph_holes": checks.holes(self.graph_ids),
            "graph_dist_err": checks.dist_err(x, x[self.graph_rows], self.graph_ids,
                                              self.graph_dist, metric),
        }


Driver = AnnBatch


def plant(fault: str, undo: list) -> None:
    """Plant ``fault`` under ``OnlineIndex.search``: the EHC step returns its
    state unchanged, or the search's answers are halved or altered."""
    import repro_torch.core.search as search
    from repro_torch.index.lifecycle import OnlineIndex

    if fault == "unchanged_state":
        faults.swap(search, "step", lambda g, x, q, st, cfg, enc=None: st, undo)
        return
    change = faults.halve if fault == "half_batch" else faults.alter
    real_search = OnlineIndex.search

    def faulty_search(self, *a, **kw):
        res = real_search(self, *a, **kw)
        ids, d = change(res.ids, res.dists)
        return res._replace(ids=ids, dists=d)
    faults.swap(OnlineIndex, "search", faulty_search, undo)
