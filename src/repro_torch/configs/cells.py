"""CellPlan: (arch x shape x mesh) -> a step the dry run traces on fakes
(counterpart of ``repro.configs.cells``).

A plan carries the step callable, its positional arguments as
``TensorSpec`` trees (shape and dtype: nothing allocated), the matching
tree of specs (``models.sharding``: a tuple per tensor of ``None``, axis
names or tuples of them), the mesh, and ``model_flops`` for the useful-
compute ratio.  The choices are the reference's, cell for cell:

  * LM train: FSDP specs (``transformer.param_pspecs(fsdp=True)``), AdamW,
    Adafactor past 10^11 parameters; batch over the data axes; unrolled
    layers, ``q_chunk = kv_chunk = max(512, S // 4)`` and ``moe_groups``
    the data-axis size.
  * LM decode: the KV cache sequence-split over 'model', batch over the
    data axes; long_500k (batch 1) splits the sequence over every axis; the
    ring cache (``opts={"split_cache": True}``) keeps the windowed layers'
    rings batch-split.
  * GNN: node and edge arrays split over every axis, padded to multiples
    of 512 with masks.
  * RecSys: tables row-split over 'model', batch over the data axes,
    retrieval candidates over every axis and padded.
  * k-NN (the paper): graph and data row-split over every axis.

``lower(cell)`` runs the step once under ``FakeTensorMode`` with the
accounting of ``launch.roofline`` (``CostMode``): it allocates nothing and
launches nothing.

* LM, GNN and recsys cells run on DTensors: parameters, optimizer state
  and batches are placed by their specs on the mesh (a CPU ``DeviceMesh``
  over a fake world of 256 or 512 ranks), the forward runs under
  ``implicit_replication()`` (the rope tables, masks and ids it makes
  itself are plain tensors, taken as replicated), and under
  ``device.card_program()``, so its products are counted as the card
  computes them (``attention.matmul_f32``'s bf16 operands with fp32 sums),
  not as the CPU widens them.
* k-NN cells plan rank 0's program: the port's k-NN parallelism is
  per-rank SPMD over a process group (``core.distributed``), not DTensor.
  Rank 0's block of ``n_total / world`` rows is made of fake tensors, and
  under ``device.card_program()`` ``kernels.ops`` routes them through the
  three registered kernels, whose fake forms run.  The step
  is ``search.init_state``, one ``search.step`` and, for the build,
  ``construct.finish_wave`` (the commit), in ``construct.wave_core``'s
  order; the build all-reduces its counts and the search all-gathers the
  (P, B, k) lists through the fake process group.  ``loop_factor =
  max_iters`` scales the step's FLOPs and bytes, as the reference's record
  scales its loop body.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.models import mace as mace_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import sharding
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An argument's shape and dtype (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    args: tuple  # positional TensorSpec trees
    in_shardings: tuple  # matching spec trees
    model_flops: Optional[float]  # 6·N·D (train) / 2·N·D (fwd) where defined
    notes: str = ""
    # the k-NN step stands for max_iters iterations of the EHC loop:
    # its FLOPs and bytes are multiplied by this factor
    loop_factor: float = 1.0
    mesh: Any = None
    rank_program: bool = False  # k-NN: rank 0's arguments are local fakes on the card


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in flat_axes(mesh))


def flat_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def mesh_size(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh.shape[flat_axes(mesh).index(a)]
    return out


def specs_of(tree):
    """A tree of tensors (real or fake) as TensorSpecs."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: specs_of(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(specs_of(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(specs_of(v) for v in tree)
    return tree


def _fake_tree(fn):
    """``fn()``'s tensors made under FakeTensorMode, as TensorSpecs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return specs_of(fn())


def _batch_spec(tree, axes):
    """Each leaf split over ``axes`` on its first dimension."""
    if isinstance(tree, dict):
        return {k: _batch_spec(v, axes) for k, v in tree.items()}
    return (axes, *([None] * (len(tree.shape) - 1)))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_plan(arch: str, shape: str, mesh, mod, opts=None) -> CellPlan:
    opts = opts or {}
    cfg: tfm.TransformerConfig = mod.full_config()
    info = dict(mod.SHAPES[shape], **({"batch": opts["batch"]} if "batch" in opts else {}))
    kind, S, B = info["kind"], info["seq"], info["batch"]
    da = data_axes(mesh)
    fa = flat_axes(mesh)
    # unrolled layers and statically tiled attention (the reference's
    # dry-run schedule: every layer and tile counted, masked tiles skipped)
    chunk = max(512, S // 4)
    cfg = dataclasses.replace(
        cfg, unrolled=True, q_chunk=chunk, kv_chunk=chunk, moe_groups=mesh_size(mesh, da))
    params = {name: TensorSpec(s, dt) for name, (s, dt) in tfm.param_shapes(cfg).items()}
    # FSDP: the big matrices split over both axes
    pspecs = tfm.param_pspecs(cfg, fsdp=True)
    n_active = cfg.active_param_count()

    if kind == "train":
        ocfg = opt_lib.OptConfig(name="adafactor" if cfg.param_count() > 1e11 else "adamw")
        opt_shapes = _fake_tree(lambda: opt_lib.init_opt_state(_fakes(params), ocfg))
        opt_specs = _opt_specs(pspecs, params, ocfg)
        step = train_loop.make_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], cfg), ocfg)
        batch = {"tokens": TensorSpec((B, S), torch.int32)}
        return CellPlan(
            arch, shape, kind, step, (params, opt_shapes, batch),
            (pspecs, opt_specs, {"tokens": (da, None)}),
            model_flops=6.0 * n_active * B * S, notes=f"opt={ocfg.name}", mesh=mesh)

    if kind == "prefill":
        def step(params, tokens):
            return tfm.prefill(params, tokens, cfg)

        return CellPlan(
            arch, shape, kind, step, (params, TensorSpec((B, S), torch.int32)),
            (pspecs, (da, None)), model_flops=2.0 * n_active * B * S, mesh=mesh)

    # decode
    split_cache = bool(opts.get("split_cache")) and (
        cfg.window is not None or cfg.local_global is not None)
    if B == 1:
        kv_spec = (None, None, fa, None, None)  # long_500k: every axis on the sequence
        len_spec = tok_spec = (None,)
    else:
        kv_spec = (None, da, "model", None, None)
        len_spec = tok_spec = (da,)
    if split_cache:
        cache = _fake_tree(lambda: tfm.init_split_cache(cfg, B, S, device="cpu"))
        # ring caches are window-sized: batch-split only; global layers keep
        # the sequence split
        ring_spec = (None, da if B > 1 else None, None, None, None)
        cache_sh = {"k_loc": ring_spec, "v_loc": ring_spec, "len": len_spec}
        if "k_glob" in cache:
            cache_sh["k_glob"] = kv_spec
            cache_sh["v_glob"] = kv_spec

        def step(params, cache, tokens):
            return tfm.decode_step_split(params, cache, tokens, cfg)

        notes = "windowed ring KV caches (exact SWA; §Perf it.4)"
    else:
        cache = _fake_tree(lambda: tfm.init_cache(cfg, B, S, device="cpu"))
        cache_sh = {"k": kv_spec, "v": kv_spec, "len": len_spec}

        def step(params, cache, tokens):
            return tfm.decode_step(params, cache, tokens, cfg)

        notes = "KV cache sequence-sharded (split-K decode)"
    return CellPlan(
        arch, shape, kind, step, (params, cache, TensorSpec((B,), torch.int32)),
        (pspecs, cache_sh, tok_spec), model_flops=2.0 * n_active * B, notes=notes, mesh=mesh)


def _fakes(tree):
    """Fake tensors of a TensorSpec tree (call under FakeTensorMode)."""
    if isinstance(tree, TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _fakes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fakes(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fakes(v) for v in tree)
    return tree


def _opt_specs(pspecs, params, ocfg):
    """``optimizer.opt_state_pspecs`` of TensorSpec parameters."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return opt_lib.opt_state_pspecs(pspecs, _fakes(params), ocfg)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_plan(arch: str, shape: str, mesh, mod) -> CellPlan:
    info = mod.SHAPES[shape]
    cfg: mace_lib.MACEConfig = mod.full_config(shape)
    fa = flat_axes(mesh)
    da = data_axes(mesh)
    params = _fake_tree(lambda: mace_lib.init_params(torch.Generator().manual_seed(0), cfg))
    pspecs = mace_lib.param_pspecs(cfg)
    ocfg = opt_lib.OptConfig(name="adamw")
    opt_shapes = _fake_tree(lambda: opt_lib.init_opt_state(_fakes(params), ocfg))
    opt_specs = _opt_specs(pspecs, params, ocfg)

    if shape == "molecule":
        Bm, N, E = info["batch"], info["n_nodes"], info["n_edges"]
        step = train_loop.make_train_step(lambda p, b: mace_lib.energy_loss(p, b, cfg), ocfg)
        batch = {
            "positions": TensorSpec((Bm, N, 3), torch.float32),
            "species": TensorSpec((Bm, N), torch.int32),
            "senders": TensorSpec((Bm, E), torch.int32),
            "receivers": TensorSpec((Bm, E), torch.int32),
            "energy": TensorSpec((Bm,), torch.float32),
        }
        mflops = 2.0 * Bm * E * cfg.d_hidden * (9 + 3 + 1) * 3  # messages fwd~
        return CellPlan(
            arch, shape, "train", step, (params, opt_shapes, batch),
            (pspecs, opt_specs, _batch_spec(batch, da)), model_flops=3.0 * mflops,
            notes="vmapped energy MSE; k-NN edges from repro.core (DESIGN §5)", mesh=mesh)

    # full-batch / sampled node classification, padded to shard boundaries
    if shape == "minibatch_lg":
        seeds = info["batch_nodes"]
        f1, f2 = info["fanout"]
        N = seeds * (1 + f1 + f1 * f2)  # sampled frontier (dups kept, padded slots)
        E = seeds * f1 + seeds * f1 * f2
        notes = f"sampled subgraph: {seeds} seeds x fanout {f1}-{f2} (data.graphs sampler)"
    else:
        N, E = info["n_nodes"], info["n_edges"]
        notes = "full-batch"
    Np, Ep = _pad_to(N, 512), _pad_to(E, 512)
    if (Np, Ep) != (N, E):
        notes += f"; padded nodes {N}->{Np}, edges {E}->{Ep} (masked)"
    step = train_loop.make_train_step(lambda p, b: mace_lib.node_class_loss(p, b, cfg), ocfg)
    batch = {
        "positions": TensorSpec((Np, 3), torch.float32),
        "species": TensorSpec((Np,), torch.int32),
        "node_feat": TensorSpec((Np, info["d_feat"]), torch.float32),
        "labels": TensorSpec((Np,), torch.int32),
        "train_mask": TensorSpec((Np,), torch.bool),
        "node_mask": TensorSpec((Np,), torch.bool),
        "senders": TensorSpec((Ep,), torch.int32),
        "receivers": TensorSpec((Ep,), torch.int32),
        "edge_mask": TensorSpec((Ep,), torch.bool),
    }
    # messages: per edge ~ (1+3+9)·C mults for A-basis x3 ranks; fwd+bwd ~3x
    mflops = 3.0 * 2.0 * Ep * cfg.d_hidden * 13 * cfg.n_layers
    return CellPlan(
        arch, shape, "train", step, (params, opt_shapes, batch),
        (pspecs, opt_specs, _batch_spec(batch, fa)), model_flops=mflops, notes=notes,
        mesh=mesh)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_plan(arch: str, shape: str, mesh, mod) -> CellPlan:
    info = mod.SHAPES[shape]
    cfg: recsys_lib.RecsysConfig = mod.full_config()
    da = data_axes(mesh)
    fa = flat_axes(mesh)
    kind = info["kind"]
    params = _fake_tree(lambda: recsys_lib.init_params(torch.Generator().manual_seed(0), cfg))
    pspecs = recsys_lib.param_pspecs(cfg)

    def batch_specs(B):
        if cfg.name in ("deepfm", "xdeepfm"):
            batch = {
                "dense": TensorSpec((B, cfg.n_dense), torch.float32),
                "sparse": TensorSpec((B, cfg.n_sparse), torch.int32),
                "label": TensorSpec((B,), torch.float32),
            }
        else:
            batch = {
                "hist": TensorSpec((B, cfg.seq_len), torch.int32),
                "target": TensorSpec((B,), torch.int32),
                "label": TensorSpec((B,), torch.float32),
            }
        return batch, _batch_spec(batch, da)

    # useful compute ~ 2 * dense-tower params per example (the embedding
    # gather is memory, not FLOPs); train ~ 3x fwd
    tower_params = sum(_numel(v) for k, v in leaves(params) if "table" not in "/".join(k))

    if kind == "train":
        B = info["batch"]
        ocfg = opt_lib.OptConfig(name="adamw")
        opt_shapes = _fake_tree(lambda: opt_lib.init_opt_state(_fakes(params), ocfg))
        opt_specs = _opt_specs(pspecs, params, ocfg)
        step = train_loop.make_train_step(lambda p, b: recsys_lib.loss_fn(p, b, cfg), ocfg)
        batch, bsh = batch_specs(B)
        return CellPlan(
            arch, shape, kind, step, (params, opt_shapes, batch), (pspecs, opt_specs, bsh),
            model_flops=3.0 * 2.0 * tower_params * B,
            notes="table row-sharded over 'model' (DLRM)", mesh=mesh)

    if kind == "serve":
        B = info["batch"]
        batch, bsh = batch_specs(B)

        def step(params, batch):
            return recsys_lib.serve_scores(params, batch, cfg)

        return CellPlan(arch, shape, kind, step, (params, batch), (pspecs, bsh),
                        model_flops=2.0 * tower_params * B, mesh=mesh)

    # retrieval_cand: 1 query x N candidates, padded to the shard multiple
    N = _pad_to(info["n_candidates"], 512)
    notes = f"candidates padded {info['n_candidates']}->{N}"
    if cfg.name in ("deepfm", "xdeepfm"):
        batch = {
            "dense": TensorSpec((1, cfg.n_dense), torch.float32),
            "sparse": TensorSpec((1, cfg.n_sparse), torch.int32),
            "cand": TensorSpec((N,), torch.int32),
        }
        bsh = {"dense": (None, None), "sparse": (None, None), "cand": (fa,)}

        def step(params, batch):
            return recsys_lib.ctr_retrieval_scores(params, batch, cfg)

        mflops = 2.0 * tower_params * N
    elif cfg.name == "bst":
        batch = {"hist": TensorSpec((1, cfg.seq_len), torch.int32),
                 "cand": TensorSpec((N,), torch.int32)}
        bsh = {"hist": (None, None), "cand": (fa,)}

        def step(params, batch):
            return recsys_lib.bst_retrieval_scores(params, batch, cfg)

        mflops = 2.0 * tower_params * N
    else:  # mind: interests once, then a (N, D) x (D, K) GEMM
        batch = {"hist": TensorSpec((1, cfg.seq_len), torch.int32),
                 "candidates": TensorSpec((N, cfg.embed_dim), torch.float32)}
        bsh = {"hist": (None, None), "candidates": (fa, None)}

        def step(params, batch):
            return recsys_lib.retrieval_scores(params, batch["hist"], batch["candidates"], cfg)

        mflops = 2.0 * N * cfg.embed_dim * cfg.n_interests
        notes += "; two-tower dot (ANN alternative: serve/retrieval.py)"
    return CellPlan(arch, shape, kind, step, (params, batch), (pspecs, bsh),
                    model_flops=mflops, notes=notes, mesh=mesh)


def _numel(spec: TensorSpec) -> int:
    out = 1
    for s in spec.shape:
        out *= s
    return out


def leaves(tree, path=()) -> list:
    """[(path, leaf)] of an argument tree: dict keys (sorted, the
    reference's pytree order) and NamedTuple fields by name, tuple entries
    by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree) for x in leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def spec_leaves(tree, path=()) -> list:
    """The leaves of a spec tree (a spec tuple is a leaf) with their paths."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree) for x in spec_leaves(v, path + (k,))]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# k-NN (the paper) cells
# ---------------------------------------------------------------------------


def graph_pspec(axes):
    """Specs of a row-split KNNGraph (``n_valid`` replicated: distributed
    builds keep the shards in lockstep)."""
    from repro_torch.core.graph import KNNGraph

    row = (axes, None)
    return KNNGraph(nbr_ids=row, nbr_dist=row, nbr_lam=row, rev_ids=row, rev_lam=row,
                    rev_ptr=(axes,), alive=(axes,), n_valid=(), sq_norms=(axes,),
                    row_scale=(axes,))


def knn_build_step(g, x, pos: int, n_real: int, seeds, cfg, group):
    """Rank 0's build wave as the dry run plans it: ``construct.wave_core``
    with its search loop cut to one iteration and no host read of
    ``done``, then the all-reduce of the wave's counts over ``group``.
    Returns (graph, the summed (comparisons, inserted edges) tensor)."""
    from repro_torch.core import construct, distributed, search

    scfg = dataclasses.replace(cfg.search_config(), seed_mode="random")
    q = construct.wave_queries(x, pos, cfg.wave)
    st = search.init_state(g, x, q, seeds, scfg)
    st = search.step(g, x, q, st, scfg)
    stats = construct.zero_stats(device=x.device)
    g2, stats, _ = construct.finish_wave(g, x, pos, n_real, search.result(st, scfg), stats, cfg)
    total = distributed.all_reduce_sum(
        torch.stack([stats.n_comps, stats.n_inserted_edges]), group)
    return g2, total


def knn_search_step(g, x, q, seeds, scfg, group, rank: int = 0):
    """Rank 0's scatter-gather search as the dry run plans it: the local
    EHC search cut to one iteration (no host read of ``done``), then
    ``distributed.merge_shard_results``'s all-gather and merge."""
    from repro_torch.core import distributed, search

    st = search.init_state(g, x, q, seeds, scfg)
    st = search.step(g, x, q, st, scfg)
    return distributed.merge_shard_results(search.result(st, scfg), rank, x.shape[0], group)


def _knn_plan(arch: str, shape: str, mesh, mod, opts=None) -> CellPlan:
    from repro_torch.core import search
    from repro_torch.core.graph import KNNGraph

    opts = opts or {}
    cfg = mod.full_config()
    info = dict(mod.SHAPES[shape], **{k: opts[k] for k in ("n_total", "batch") if k in opts})
    fa = flat_axes(mesh)
    ndev = mesh_size(mesh, fa)
    n_total, d = info["n_total"], info["d"]
    if n_total % ndev:
        raise ValueError(f"{n_total} rows do not split over {ndev} ranks")
    R = cfg.rev_cap or 2 * cfg.k
    f32, i32 = torch.float32, torch.int32
    g_shapes = KNNGraph(
        nbr_ids=TensorSpec((n_total, cfg.k), i32),
        nbr_dist=TensorSpec((n_total, cfg.k), f32),
        nbr_lam=TensorSpec((n_total, cfg.k), i32),
        rev_ids=TensorSpec((n_total, R), i32),
        rev_lam=TensorSpec((n_total, R), i32),
        rev_ptr=TensorSpec((n_total,), i32),
        alive=TensorSpec((n_total,), torch.bool),
        n_valid=TensorSpec((), i32),
        sq_norms=TensorSpec((n_total,), f32),
        row_scale=TensorSpec((n_total,), f32),
    )
    g_sh = graph_pspec(fa)
    x_dtype = torch.bfloat16 if cfg.data_bf16 else f32
    x_shapes = TensorSpec((n_total, d), x_dtype)
    key_s = TensorSpec((2,), torch.uint32)  # the entry points' key (the port draws them)
    if info["kind"] == "knn_build":
        # the entry points are uniform over the shard's allocated rows (the
        # distributed steps draw them from the wave's key)
        def step(g, x, pos, n_real, key, group):
            seeds = search.random_seeds(cfg.wave, cfg.n_seeds, g.n_valid, None, x.device)
            return knn_build_step(g, x, pos, n_real, seeds, cfg, group)

        args = (g_shapes, x_shapes, TensorSpec((), i32), TensorSpec((), i32), key_s)
        shs = (g_sh, (fa, None), (), (), (None,))
        W = cfg.wave
        # useful work: one wave of W queries x (expansions x candidate dists)
        mflops = 2.0 * W * cfg.max_iters * (cfg.k + R) * d * ndev
        notes = f"per-shard online insertion, wave={W}/shard, zero-collective"
        lf = float(cfg.max_iters)
    else:
        scfg = dataclasses.replace(cfg.search_config(), seed_mode="random")

        def step(g, x, q, key, group):
            seeds = search.random_seeds(q.shape[0], scfg.n_seeds, g.n_valid, None, x.device)
            return knn_search_step(g, x, q, seeds, scfg, group)

        B = info["batch"]
        args = (g_shapes, x_shapes, TensorSpec((B, d), f32), key_s)
        shs = (g_sh, (fa, None), (None, None), (None,))
        mflops = 2.0 * B * scfg.max_iters * (scfg.k + R) * d * ndev
        notes = "scatter-gather EHC + tournament top-k merge"
        lf = float(cfg.max_iters)
    return CellPlan(arch, shape, info["kind"], step, args, shs, mflops, notes,
                    loop_factor=lf, mesh=mesh, rank_program=True)


# ---------------------------------------------------------------------------


def plan(arch: str, shape: str, mesh, opts=None) -> CellPlan:
    """The plan of one cell on ``mesh`` (a DeviceMesh with named axes).
    ``opts``: ``split_cache`` (LM decode: the ring caches), ``batch`` (a
    smaller batch for an LM or k-NN cell), ``n_total`` (k-NN rows)."""
    sharding.set_mesh(mesh)  # activate constrain() for this mesh
    mod = configs.get(arch)
    if shape not in mod.SHAPES:
        raise KeyError(f"{arch} has no shape {shape!r}")
    fam = mod.FAMILY
    if fam == "lm":
        return _lm_plan(arch, shape, mesh, mod, opts)
    if fam == "gnn":
        return _gnn_plan(arch, shape, mesh, mod)
    if fam == "recsys":
        return _recsys_plan(arch, shape, mesh, mod)
    if fam == "knn":
        return _knn_plan(arch, shape, mesh, mod, opts)
    raise ValueError(fam)


def place_args(cell: CellPlan):
    """The cell's arguments as fakes (call under FakeTensorMode): DTensors
    placed by their specs on the cell's mesh, or, for a k-NN cell, rank 0's
    local blocks with its scalars as host ints."""
    if not cell.rank_program:
        return tuple(sharding.place(_fakes(a), s, cell.mesh)
                     for a, s in zip(cell.args, cell.in_shardings))
    return tuple(_rank_block(a, s, cell.mesh) for a, s in zip(cell.args, cell.in_shardings))


def _rank_block(tree, spec, mesh):
    if isinstance(tree, TensorSpec):
        if not tree.shape:  # a step scalar (n_valid, pos, n_real): a host int
            return 0
        shape, _ = sharding.block(tree.shape, mesh, sharding.placements(mesh, spec),
                                  coordinate=[0] * mesh.ndim)
        return torch.empty(shape, dtype=tree.dtype)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rank_block(v, s, mesh) for v, s in zip(tree, spec)))
    raise TypeError(f"cannot place {type(tree).__name__}")


def lower(cell: CellPlan):
    """Run the cell's step once under ``FakeTensorMode`` with the per-rank
    accounting (``launch.roofline.CostMode``) and return its
    ``roofline.Lowered``: nothing is allocated or launched."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import roofline

    _register_card_products()
    with FakeTensorMode():
        args = place_args(cell)
        extra = ()
        if cell.rank_program:
            args = _knn_state(cell, args)
            extra = (dist.group.WORLD,)
        mode = roofline.CostMode()
        mode.hold(args)
        with mode, implicit_replication(), device_lib.card_program():
            out = cell.step_fn(*args, *extra)
        del out
        arg_bytes = sharding.local_bytes(args)
    return mode.lowered(arg_bytes, cell.notes)


def _knn_state(cell: CellPlan, args):
    """Rank 0's k-NN arguments with its shard full (``n_valid``), a wave at
    the end of the shard for the build (``pos``, ``n_real``)."""
    g = args[0]
    n_local = g.capacity
    if cell.kind == "knn_build":
        cfg = configs.get(cell.arch).full_config()
        pos = max(n_local - cfg.wave, 0)
        return (g._replace(n_valid=pos), args[1], pos, min(cfg.wave, n_local - pos), args[4])
    return (g._replace(n_valid=n_local), *args[1:])


def _register_card_products() -> None:
    """Give DTensor a sharding rule for ``torch.bmm(..., out_dtype=)``, the
    card's bf16 product in ``attention.matmul_f32`` (the rule of ``bmm``:
    the output dtype changes no placement)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops._matrix_ops import bmm_strategy

    from torch.distributed.tensor._op_schema import OpSchema

    def bmm_dtype_strategy(op_schema):
        return bmm_strategy(OpSchema(op_schema.op, op_schema.args_schema[:2], {}))

    prop = DTensor._op_dispatcher.sharding_propagator
    if torch.ops.aten.bmm.dtype not in prop.op_strategy_funcs:
        prop.register_op_strategy(torch.ops.aten.bmm.dtype, bmm_dtype_strategy)
