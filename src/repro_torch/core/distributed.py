"""Sharded-graph parallelism over a ``torch.distributed`` process group
(counterpart of ``repro.core.distributed``).

The reference runs one controller over a JAX mesh and ``shard_map``s its
steps.  Here the same deployment is SPMD: one process per shard
(``launch.mesh.init_group``), every rank calling the same function with the
same arguments and owning shard ``rank`` of a row-partitioned dataset.

* **build** — each rank inserts its own next W rows into its own graph
  (``wave_step``, the one ``construct.wave_core``), entry points drawn from
  ``fold_in(rank)`` of the wave's draws; the only collective is the
  all-reduced stats (``make_distributed_build_step``).
* **search** — scatter-gather: every rank runs the local EHC search,
  maps its ids to global ones (``rank * shard_rows + local``), and one
  all-gather of the (P, B, k) ids and distances feeds the same stable top-k
  merge on every rank (``make_distributed_search``).  A shard whose rows
  are all dead serves nothing and the rest still answer.
* **divide and conquer** — ``build_subgraphs`` builds one sub-graph per
  rank and hands every rank all of them; ``merge_pairs_mesh`` merges one
  pair per rank through the same ``merge.merge_commit_core`` as the host
  path and hands every rank every merged graph.

What the reference replicates (search results, merged graphs, counters)
comes back equal on every rank; sharded state stays sharded.  Draws come
from a ``core.draws.Draws`` along the reference's key chain (the parity
tests replay its keys).  Over gloo a collective on CUDA tensors stages them
through the host (several ranks sharing one card); over nccl they stay on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import brute, merge
from repro_torch.core import construct as construct_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import search as search_lib
from repro_torch.core.draws import Draws, TorchDraws, derive_kw, search_entry
from repro_torch.core.graph import KNNGraph
from repro_torch.kernels import ops

# graph fields that are tensors, in KNNGraph order
_TENSOR_FIELDS = tuple(f for f in KNNGraph._fields if f != "n_valid")


# ---------------------------------------------------------------------------
# Ranks, row shards and collectives
# ---------------------------------------------------------------------------


def shard_index(group=None) -> int:
    """This process's shard: its rank within ``group``."""
    return dist.get_rank(group)


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def shard_rows(n_total: int, shards: int) -> int:
    """Rows per shard of a contiguous row split; n_total must divide."""
    if n_total % shards:
        raise ValueError(f"a row-sharded dataset needs n % shards == 0, got n={n_total} "
                         f"over {shards} shards")
    return n_total // shards


def local_block(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's contiguous block of the rows of ``x``."""
    n_local = shard_rows(x.shape[0], world_size(group))
    lo = shard_index(group) * n_local
    return x[lo:lo + n_local]


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as a collective moves it: bool as uint8, and on the CPU when a
    gloo group meets a CUDA tensor (several ranks on one card)."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t`` in rank order, on every rank."""
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.stack(parts).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a rank in ``group``) on every rank; the other
    ranks' ``t`` gives the shape and is not written."""
    w = _wire(t, group)
    if w is t:
        w = t.clone()
    dist.broadcast(w, src=dist.get_global_rank(group or dist.group.WORLD, src), group=group)
    return w.to(device=t.device, dtype=t.dtype)


def broadcast_graph(g: KNNGraph, src: int, group=None) -> KNNGraph:
    """Rank ``src``'s graph on every rank; every rank passes a graph of the
    same shapes (its own is left untouched)."""
    fields = {f: broadcast(getattr(g, f), src, group) for f in _TENSOR_FIELDS}
    n_valid = int(broadcast(torch.tensor([g.n_valid], dtype=torch.int64), src, group))
    return KNNGraph(n_valid=n_valid, **fields)


def all_gather_graphs(g: KNNGraph, group=None) -> list[KNNGraph]:
    """Every rank's graph, in rank order, on every rank (equal shapes)."""
    fields = {f: all_gather(getattr(g, f), group) for f in _TENSOR_FIELDS}
    n_valid = all_gather(torch.tensor([g.n_valid], dtype=torch.int64), group)
    return [KNNGraph(n_valid=int(n_valid[s]), **{f: v[s] for f, v in fields.items()})
            for s in range(world_size(group))]


# ---------------------------------------------------------------------------
# Sharded online build and scatter-gather search
# ---------------------------------------------------------------------------


def wave_step(g: KNNGraph, x: torch.Tensor, pos: int, n_real: int, seeds: torch.Tensor,
              cfg: construct_lib.BuildConfig):
    """One search + commit wave of a shard (rows [pos, pos + n_real) of its
    block ``x``): a thin adapter over ``construct.wave_core``.  Returns
    (graph, comparisons, edges inserted) of this shard, the counts as 0-d
    int64 tensors."""
    g2, stats, _ = construct_lib.wave_core(
        g, x, pos, seeds, construct_lib.zero_stats(device=x.device), cfg, n_real=n_real)
    return g2, stats.n_comps, stats.n_inserted_edges


def make_distributed_build_step(group, cfg: construct_lib.BuildConfig):
    """The shard step: ``step(g, x, pos, n_real, draws) -> (g, comps,
    edges)``, with ``g``/``x`` this rank's graph and block and ``draws`` the
    wave's (equal on every rank).  The rank's entry points come from
    ``draws.fold_in(rank)``, random-seeded; the returned counts are summed
    over the group (the step's only collective), as ints."""
    rank = shard_index(group)

    def step(g, x, pos: int, n_real: int, draws: Draws):
        seeds = search_entry(draws.fold_in(rank), cfg.wave, cfg.n_seeds, g.n_valid,
                             device=x.device)
        g2, comps, edges = wave_step(g, x, pos, n_real, seeds, cfg)
        total = all_reduce_sum(torch.stack([comps, edges]), group)
        return g2, int(total[0]), int(total[1])

    return step


def make_distributed_search(group, scfg: search_lib.SearchConfig):
    """Scatter-gather search: ``search(g, x, q, draws) -> (ids (B, k)
    global, dists (B, k))``, equal on every rank.  ``g``/``x`` are this
    rank's graph and block, ``q`` the same queries on every rank; the local
    search seeds randomly from ``draws.fold_in(rank)``, local ids map to
    ``rank * shard_rows + local``, and the all-gathered (P, B, k) lists
    merge by a stable top-k (ties to the lower shard)."""
    rank = shard_index(group)
    scfg = dataclasses.replace(scfg, seed_mode="random")

    def search(g: KNNGraph, x: torch.Tensor, q: torch.Tensor, draws: Draws):
        B = q.shape[0]
        seeds = search_entry(draws.fold_in(rank), B, scfg.n_seeds, g.n_valid, device=x.device)
        res = search_lib.search(g, x, q, scfg, seeds=seeds, device=x.device)
        return merge_shard_results(res, rank, x.shape[0], group)

    return search


def merge_shard_results(res: search_lib.SearchResult, rank: int, n_local: int, group):
    """The scatter-gather merge of a shard's local search result: local ids
    map to ``rank * n_local + local``, one all-gather of the (P, B, k) ids
    and distances, and the same stable top-k (ties to the lower shard) on
    every rank.  Returns (ids (B, k) global, dists (B, k))."""
    B, k = res.ids.shape
    gids = torch.where(res.ids >= 0, res.ids + rank * n_local, -1)
    all_ids = all_gather(gids, group)  # (P, B, k)
    all_d = all_gather(res.dists, group)
    P = all_ids.shape[0]
    cat_i = all_ids.permute(1, 0, 2).reshape(B, P * k)
    cat_d = all_d.permute(1, 0, 2).reshape(B, P * k)
    d, i = ops.topk_smallest(cat_d, cat_i, k)
    return i, d


def init_sharded_state(group, x: torch.Tensor, cfg: construct_lib.BuildConfig, *, device=None):
    """This rank's (graph, block) of the rows of ``x`` (the same on every
    rank): an exact |I|-row seed graph over its block (Alg. 2 lines 4-5 per
    shard), the block stored as ``cfg`` stores data.  The reference draws
    its shards' rows itself; here the caller gives them."""
    xs = construct_lib.stored_data(local_block(x, group), cfg, device)
    n_seed = min(cfg.n_seed_init, xs.shape[0])
    g = brute.exact_seed_graph(xs, n_seed, cfg.k, cfg.metric, rev_capacity=cfg.rev_cap,
                               device=xs.device)
    return g, xs


def build_subgraphs(group, x: torch.Tensor, cfg: construct_lib.BuildConfig,
                    draws: Optional[Draws] = None, *, device=None):
    """One sub-graph per rank over real data, ``construct.build_parallel``'s
    mesh backend.

    ``x`` (the same on every rank) splits into one contiguous block per
    rank; each rank seeds an exact |I|-graph over its block and runs the
    shard step in lockstep waves, wave w drawing from the w-th split of
    ``draws`` (default ``TorchDraws(0)``).  Under ``seed_mode="coarse"``
    each block then gets a derived level in its local ids (maintenance,
    uncharged), keyed by ``fold_in(500_000 + s)`` of the chain's last draws.
    Every rank returns every shard's graph and level:

      (graphs, coarses, n_comps, n_waves over all shards, n_edges)
    """
    from repro_torch.core import hierarchy  # late: hierarchy imports construct

    P = world_size(group)
    n = x.shape[0]
    if n % P:
        raise ValueError(f"build_subgraphs needs n % world size == 0, got n={n} over {P} ranks")
    draws = TorchDraws(0) if draws is None else draws
    g, xs = init_sharded_state(group, x, cfg, device=device)
    n_local, n_seed = xs.shape[0], g.n_valid
    step = make_distributed_build_step(group, cfg)
    comps = edges = n_waves = 0
    pos = n_seed
    while pos < n_local:
        nr = min(cfg.wave, n_local - pos)
        draws, sub = draws.split()
        g, c, e = step(g, xs, pos, nr, sub)
        comps += c
        edges += e
        pos += nr
        n_waves += 1
    graphs = all_gather_graphs(g, group)
    coarses: list = [None] * P
    if cfg.seed_mode == "coarse":
        xd = construct_lib.stored_data(x, cfg, xs.device)
        for s, gs in enumerate(graphs):
            dev = xs.device
            coarses[s] = hierarchy.derive_coarse(
                gs, xd[s * n_local:(s + 1) * n_local], cfg, device=dev,
                **derive_kw(draws.fold_in(500_000 + s), gs, cfg, dev))
    total_comps = P * (n_seed * (n_seed - 1) // 2) + comps
    return graphs, coarses, total_comps, n_waves * P, edges


# ---------------------------------------------------------------------------
# Mesh-resident merge level
# ---------------------------------------------------------------------------


def merge_pairs_mesh(group, pairs, xs, scfg: search_lib.SearchConfig, draws, coarses=None):
    """Merge P equal-shape sub-graph pairs, pair r on rank r, the mesh fold
    level of ``merge.merge_subgraphs``; P must not exceed the world size.

    Every rank passes the same ``pairs`` ((g_a, g_b), fully allocated),
    ``xs`` (each pair's (n_a + n_b, d) rows), ``draws`` (one per pair) and
    optional ``coarses`` ((coarse_a, coarse_b) per pair, all present; the
    cross searches then seed coarsely, else randomly).  A pair's draws split
    between its two cross searches as the reference's key does, and each
    searches a whole side in one batch, as the reference's does: a lane
    that has converged is still stepped while others of its batch run, and
    such a step can move its beam (a hole left by the merge's dedupe sorts
    to the end), so a batch cut into chunks would give some lanes other
    neighbours.  Each merge runs the cross searches and
    ``merge.merge_commit_core``, as the host path does.

    Returns (every merged graph, on every rank; the comps of all the cross
    searches and hop proposals, an int)."""
    P_n, P = len(pairs), world_size(group)
    if P_n > P:
        raise ValueError(f"{P_n} pairs for a group of {P} ranks")
    rank = shard_index(group)
    use_coarse = coarses is not None and scfg.seed_mode == "coarse"
    scfg_eff = scfg if use_coarse else dataclasses.replace(scfg, seed_mode="random")
    g0a, g0b = pairs[0]
    dev = xs[0].device
    comps = torch.zeros((), dtype=torch.int64, device=dev)
    mine = None
    if rank < P_n:
        g_a, g_b = pairs[rank]
        merge._check_allocated(g_a, g_b, "merge_pairs_mesh")
        n_a = g_a.capacity
        xa, xb = xs[rank][:n_a], xs[rank][n_a:]
        d_ab, d_ba = draws[rank].split()
        ca, cb = coarses[rank] if use_coarse else (None, None)
        ab_ids, ab_d, c_ab = _full_batch_search(g_b, xb, xa, d_ab, scfg_eff, cb)
        ba_ids, ba_d, c_ba = _full_batch_search(g_a, xa, xb, d_ba, scfg_eff, ca)
        mine, hop_c = merge.merge_commit_core(g_a, g_b, xa, xb, ab_ids, ab_d, ba_ids, ba_d,
                                              scfg.metric)
        comps = comps + c_ab + c_ba + hop_c
    like = graph_lib.empty_graph(g0a.capacity + g0b.capacity, g0a.k,
                                 max(g0a.rev_capacity, g0b.rev_capacity), device=dev)
    merged = [broadcast_graph(mine if rank == r else like, r, group) for r in range(P_n)]
    return merged, int(all_reduce_sum(comps, group))


def _full_batch_search(g, xg, queries, draws, scfg, coarse):
    """The reference's one cross search of all of ``queries`` against
    ``g``, entry points drawn once for the whole batch.  Returns (ids,
    dists, comps as a 0-d tensor)."""
    n_landmarks = coarse.n_landmarks if scfg.seed_mode == "coarse" else None
    entry = search_entry(draws, queries.shape[0], scfg.n_seeds, g.n_valid, n_landmarks,
                         queries.device)
    seeds, coarse_seeds = entry if isinstance(entry, tuple) else (entry, None)
    res = search_lib.search(g, xg, queries, scfg, seeds=seeds, coarse=coarse,
                            coarse_seeds=coarse_seeds, device=queries.device)
    return res.ids, res.dists, res.n_comps.sum()
