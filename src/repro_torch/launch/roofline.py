"""The dry run's record on the H100's terms (counterpart of
``repro.launch.roofline``), and the per-rank cost accounting it reads.

Per (arch x shape x mesh), planned, not measured:

  compute    = Σ_dtype FLOPs_dtype / peak_dtype   (bf16 989e12, fp32 67e12)
  memory     = bytes / 3.35e12 B/s                 (HBM3)
  collective = collective bytes / 50e9 B/s         (one 400 Gb/s IB NDR port)

The rates are ``launch.profile_build``'s, from the H100 SXM 80GB (700 W)
data sheet: dense bf16 products on the tensor cores, IEEE fp32 on the CUDA
cores (the port runs no TF32).  Every collective is charged at one
InfiniBand NDR port per GPU, as on a DGX H100: both production meshes span
32 or 64 nodes of eight cards, so their groups cross nodes.  A group inside
one node would ride NVLink at 450 GB/s per direction; charging it to the
InfiniBand rate is the conservative choice, as the reference charges every
collective to ICI.

The reference reads FLOPs, bytes and peak memory from XLA's compiled
program.  Here ``CostMode`` counts rank 0's program while the step runs
once under ``FakeTensorMode`` (shapes only: nothing is allocated and no
kernel runs):

* it sits below DTensor: an operation on DTensors is let through
  (``NotImplemented``), and the local operations DTensor issues on rank 0's
  blocks, collectives included, come back to the mode and are counted, so
  a sharded product counts one rank's FLOPs, not the global ones that
  ``FlopCounterMode`` sees.  The operations DTensor runs on global fakes to
  propagate shapes are not counted;
* FLOPs are the matrix products' (2·M·K·N for ``mm``/``addmm``, per batch
  for ``bmm``/``baddbmm``), keyed by their operand type; elementwise work is
  charged in the memory term only;
* bytes: every operation reads its tensor inputs and writes its outputs
  once; a gather reads only the rows it gathers (its output and index), a
  scatter only what it writes; views move nothing;
* a registered kernel (``repro_torch::*``, ``kernels._cuda.register_op``)
  is charged by its own cost function, never as the operations inside it;
* peak bytes: the live bytes of every storage the step makes, from its
  fakes' storages (freed when the step drops them), at their highest, plus
  the arguments;
* collectives: DTensor's functional collectives and the process-group
  calls of the k-NN cells, each as (kind, result bytes, group size).
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional, Sequence

import re

import torch

from torch.utils._python_dispatch import TorchDispatchMode, _pop_mode, _push_mode
from torch.utils._pytree import tree_map as _tree_map
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _cuda
from repro_torch.launch import profile_build

HBM_BW = profile_build.HBM_BYTES_PER_S  # 3.35e12 B/s, HBM3
PEAK_FLOPS = {  # per second, by the products' operand type
    torch.bfloat16: profile_build.FLOP_PER_S["bf16"],  # 989e12, dense, tensor cores
    torch.float32: profile_build.FLOP_PER_S["fp32"],  # 67e12, CUDA cores
}
NET_BW = 50e9  # B/s per GPU: one 400 Gb/s InfiniBand NDR port (DGX H100)
HBM_BYTES = 80 * 2**30  # the card's memory: the plan fits when its peak does


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as the accounting saw it: ``kind`` (all-gather,
    all-reduce, reduce-scatter, all-to-all or collective-permute), the byte
    sizes of its results on this rank, the size of its group, and
    ``variant`` ``"-start"``/``"-done"`` for the halves of an asynchronous
    one (None when it is one call)."""

    kind: str
    result_bytes: tuple
    group_size: int
    variant: Optional[str] = None


def collective_bytes(colls: Sequence[Collective]) -> dict:
    """Per-rank network traffic of ``colls``, by the reference's ring
    conventions (g = group size, at least 2):

      all-gather        : result bytes x (g-1)/g     (received)
      all-reduce        : 2 x bytes x (g-1)/g        (reduce-scatter + AG)
      reduce-scatter    : result bytes x (g-1)       (sends everyone's shard)
      all-to-all        : bytes x (g-1)/g            (keeps own shard)
      collective-permute: result bytes

    A ``"-done"`` half is skipped (the ``"-start"`` carries the sizes, the
    largest of its results counting).  Returns {kind: bytes, "_total": ...,
    "_count": n_ops}."""
    out: dict = {}
    n_ops = 0
    for c in colls:
        if c.variant == "-done" or not c.result_bytes:
            continue
        b = max(c.result_bytes) if c.variant else sum(c.result_bytes)
        g = max(int(c.group_size), 2)
        if c.kind == "all-gather":
            traffic = b * (g - 1) / g
        elif c.kind == "all-reduce":
            traffic = 2.0 * b * (g - 1) / g
        elif c.kind == "reduce-scatter":
            traffic = b * (g - 1)
        elif c.kind == "all-to-all":
            traffic = b * (g - 1) / g
        else:  # collective-permute
            traffic = float(b)
        out[c.kind] = out.get(c.kind, 0.0) + traffic
        n_ops += 1
    out["_total"] = sum(v for k, v in out.items() if not k.startswith("_"))
    out["_count"] = n_ops
    return out


# ---------------------------------------------------------------------------
# The accounting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_PRODUCTS = {  # packet -> (index of operand a, index of operand b)
    _aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2), _aten.baddbmm: (1, 2),
}
# reads only what they gather: output bytes plus index bytes
_GATHERS = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding,
            _aten.take_along_dim}
# write in place only what they scatter: read values and indices, write values
_SCATTERS = {_aten.index_put_, _aten.index_put, _aten.scatter_, _aten.scatter_add_,
             _aten.index_add_, _aten._index_put_impl_, _aten.scatter_reduce_}
_FREE = {_aten.detach, _aten.lift_fresh, _aten.alias, _aten._unsafe_view}
_WAITS = {torch.ops._c10d_functional.wait_tensor}
_UNEVEN = re.compile(r"unevenly sharded tensor.*mesh dimension (\d+)")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _product_flops(func, args) -> tuple:
    """(FLOPs, operand dtype) of a matrix product from its shapes."""
    ia, ib = _PRODUCTS[func._overloadpacket]
    a, b = args[ia], args[ib]
    if a.dim() == 2:
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[-1], a.dtype
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1], a.dtype


class _Propagating:
    """Counts the calls in flight of DTensor's shape propagation
    (``ShardingPropagator._propagate_tensor_meta_non_cached``, wrapped by
    ``CostMode`` while it is active), which runs each operation on global
    fakes to derive its output's shape: those operations are no part of the
    rank's program."""

    def __init__(self):
        self.depth = 0

    def wrap(self, fn):
        def propagate(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1

        return propagate


def _group_size(pg) -> int:
    """The size of a process group as a c10d operator receives it (a
    ScriptObject, unboxed to the ProcessGroup)."""
    import torch.distributed as dist

    if not isinstance(pg, dist.ProcessGroup):
        pg = dist.ProcessGroup.unbox(pg)
    return pg.size()


def _collective_of(func, args, out) -> Optional[Collective]:
    """A ``Collective`` for DTensor's functional collectives and the
    process-group calls, None for any other operation."""
    ns, name = func.namespace, func._opname
    from torch.distributed.distributed_c10d import _resolve_process_group

    res = tuple(_nbytes(t) for t in _tensors(out))
    if ns == "_c10d_functional":
        if name.startswith("all_gather_into_tensor"):
            return Collective("all-gather", res, int(args[1]))
        if name.startswith("all_reduce"):
            return Collective("all-reduce", res, _resolve_process_group(args[-1]).size())
        if name.startswith("reduce_scatter_tensor"):
            return Collective("reduce-scatter", res, int(args[2]))
        if name.startswith("all_to_all_single"):
            return Collective("all-to-all", res, _resolve_process_group(args[-1]).size())
        if name == "broadcast":
            return Collective("collective-permute", res, _resolve_process_group(args[-1]).size())
        return None
    if ns == "c10d":
        if name.startswith("allreduce"):
            return Collective("all-reduce", tuple(_nbytes(t) for t in _tensors(args[0])),
                              _group_size(args[1]))
        if name.startswith("allgather"):
            # allgather_(output lists, inputs, group, ...): the result is
            # every rank's block
            return Collective("all-gather", (sum(_nbytes(t) for t in _tensors(args[0])),),
                              _group_size(args[2]))
        if name.startswith("broadcast"):
            return Collective("collective-permute", tuple(_nbytes(t) for t in _tensors(args[0])),
                              _group_size(args[1]))
    return None


def _strided_size_and_offset(self, curr_local_size, num_chunks, rank, *args, **kwargs):
    """``_StridedShard.local_shard_size_and_offset`` in plain integers: the
    dimension splits into ``split_factor`` pieces and each piece into
    ``num_chunks`` chunks (``torch.chunk``'s sizes), the rank holding its
    chunk of every piece.  DTensor computes the same from a
    ``torch.arange`` of the dimension that it reads back, which a fake
    tensor cannot answer and which costs a chunk per element.  The last
    argument is the offsets wanted, as either PyTorch release spells it: a
    ``return_first_offset`` flag, or an ``offset_mode`` (FIRST, ALL, NONE)."""
    mode = args[0] if args else kwargs.get("offset_mode", kwargs.get("return_first_offset"))
    want = getattr(mode, "name", None) or {None: "FIRST", True: "FIRST", False: "ALL"}[mode]
    n, sf, rank = int(curr_local_size), int(self.split_factor), int(rank)
    first = -(-n // sf)
    size, offsets = 0, []
    for piece in range(sf):
        start = min(first * piece, n)
        length = max(0, min(first * (piece + 1), n) - start)
        second = -(-length // num_chunks)
        a, b = min(second * rank, length), min(second * (rank + 1), length)
        size += max(0, b - a)
        if want != "NONE" and b > a:
            offsets.extend(range(start + a, start + b))
    if want == "NONE":
        return size, None
    if want == "FIRST":
        return size, offsets[0] if offsets else -1
    return size, offsets


class CostMode(TorchDispatchMode):
    """Count the program that runs under it, as rank 0 runs it (module
    docstring).  Use under ``FakeTensorMode``, entered after it."""

    def __init__(self):
        super().__init__()
        self.flops: dict = collections.Counter()  # operand dtype -> FLOPs
        self.bytes_read = 0.0
        self.bytes_written = 0.0
        self.collectives: list = []
        self.kernels: collections.Counter = collections.Counter()  # op name -> calls
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self._prop = _Propagating()
        self._saved = None
        self._passing = False
        self.resharded: collections.Counter = collections.Counter()  # op -> operand gathers

    def _hooks(self) -> list:
        """(owner, attribute, planning value) of the DTensor internals the
        accounting replaces while it is active (each restored on exit):

        * the shape propagation, wrapped to mark its operations
          (``_Propagating``);
        * a strided shard's offsets, in plain integers
          (``_strided_size_and_offset``);
        * the redistribution planner's min-cost graph search, which DTensor
          takes where a dimension is split over several mesh dimensions and
          which runs for minutes per operation on the 2x16x16 mesh: the plan
          redistributes by DTensor's greedy planner instead, one mesh
          dimension at a time."""
        from torch.distributed.tensor._redistribute import DTensorRedistributePlanner as Planner
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        def greedy(planner, src_spec, dst_spec, full_tensor_shape):
            return planner.generate_greedy_transform_infos(src_spec, dst_spec)

        return [
            (ShardingPropagator, "_propagate_tensor_meta_non_cached",
             self._prop.wrap(ShardingPropagator._propagate_tensor_meta_non_cached)),
            (_StridedShard, "local_shard_size_and_offset", _strided_size_and_offset),
            (Planner, "generate_graph_based_transform_infos", greedy),
        ]

    def __enter__(self):
        self._saved = []
        for owner, name, value in self._hooks():
            self._saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, value)
        return super().__enter__()

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return super().__exit__(*exc)

    # -- storages ----------------------------------------------------------
    def hold(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors (a DTensor's local block)
        as held already: the step's arguments, counted apart."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            self._storages[t.untyped_storage()] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor issues rank 0's local operations, which come back here
            if self._passing:  # ``_dtensor``'s own call: DTensor takes it
                self._passing = False
                return NotImplemented
            _push_mode(self)
            try:
                return self._dtensor(func, args, kwargs)
            finally:
                _pop_mode()
        out = func(*args, **kwargs)
        if self._prop.depth:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _dtensor(self, func, args, kwargs):
        """DTensor's dispatch of ``func``.  Where DTensor cannot place an
        operation as its operands are split, the plan first gathers the
        operands over the mesh dimensions concerned, as XLA's partitioner
        reshards them, and says so in ``resharded``: over the mesh dimension
        that splits a dimension unevenly, where DTensor refuses to view it (a
        head count that does not divide the 'model' axis); else over every
        mesh dimension on which the operands' placements differ; else over
        the later mesh dimensions of a dimension split over several.  An
        error that the gathers do not cure is raised as it was."""
        from torch.distributed.tensor import DTensor, Replicate

        def dispatch(func, args, kwargs):
            self._passing = True
            try:
                return func(*args, **kwargs)
            finally:
                self._passing = False

        first = None
        for _ in range(4):
            try:
                return dispatch(func, args, kwargs)
            except RuntimeError as e:
                first = first or e
                operands = [t for t in _tensors((args, kwargs)) if isinstance(t, DTensor)]
                m = _UNEVEN.search(str(e))
                if m is not None:
                    dims = {int(m.group(1))}
                else:
                    dims = {d for d in range(operands[0].device_mesh.ndim) if len(
                        {str(t.placements[d]) for t in operands}) > 1} if operands else set()
                    dims = {d for d in dims if any(t.placements[d].is_shard() for t in operands)}
                if not dims:  # a dimension split over several mesh dimensions: keep the first
                    dims = {d for t in operands for d, p in enumerate(t.placements)
                            if p.is_shard() and any(q.is_shard() and q.dim == p.dim
                                                    for q in t.placements[:d])}
                if not dims:
                    raise first

            def gather(t):
                if not isinstance(t, DTensor) or all(t.placements[d].is_replicate() for d in dims):
                    return t
                pl = [Replicate() if d in dims else p for d, p in enumerate(t.placements)]
                return t.redistribute(t.device_mesh, pl)

            args, kwargs = _tree_map(gather, (args, kwargs))
            self.resharded[str(func._overloadpacket)] += 1
        try:
            return dispatch(func, args, kwargs)
        except RuntimeError:
            raise first

    def _count(self, func, args, kwargs, out) -> None:
        from torch._subclasses.fake_tensor import FakeTensor

        outs = _tensors(out)
        if outs and not any(isinstance(t, FakeTensor) for t in outs):
            return  # DTensor's own index arithmetic on real tensors
        for t in outs:
            self._track(t)
        coll = _collective_of(func, args, out)
        if coll is not None:
            self.collectives.append(coll)
            return
        if func in _cuda.COSTS:
            c = _cuda.COSTS[func](*args, **kwargs)
            for dt, f in c["flops"].items():
                self.flops[dt] += f
            self.bytes_read += c["bytes_read"]
            self.bytes_written += c["bytes_written"]
            self.kernels[func._schema.name] += 1
            return
        packet = func._overloadpacket
        if packet in _WAITS:  # the second half of a collective counted at its start
            return
        if func.is_view or packet in _FREE or not outs and packet not in _SCATTERS:
            return
        ins = _tensors((args, kwargs))
        if packet in _PRODUCTS:
            f, dt = _product_flops(func, args)
            self.flops[dt if dt in PEAK_FLOPS else torch.float32] += f
        if packet in _GATHERS:  # the source is the first tensor, the indices the rest
            self.bytes_read += sum(map(_nbytes, outs)) + sum(map(_nbytes, ins[1:]))
            self.bytes_written += sum(map(_nbytes, outs))
        elif packet in _SCATTERS:
            moved = sum(map(_nbytes, ins[1:]))
            self.bytes_read += moved
            self.bytes_written += moved
        else:
            self.bytes_read += sum(map(_nbytes, ins))
            self.bytes_written += sum(map(_nbytes, outs))

    def lowered(self, arg_bytes: int, notes: str = "") -> "Lowered":
        if self.resharded:
            gathers = ", ".join(f"{op} x{n}" for op, n in sorted(self.resharded.items()))
            notes = f"{notes}; operands gathered before uneven views: {gathers}".lstrip("; ")
        return Lowered(
            flops=dict(self.flops), bytes_read=self.bytes_read,
            bytes_written=self.bytes_written, peak_bytes=arg_bytes + self.peak,
            arg_bytes=arg_bytes, collectives=list(self.collectives),
            kernels=dict(self.kernels), notes=notes)


@dataclasses.dataclass
class Lowered:
    """One traced step of rank 0 (``configs.cells.lower``): FLOPs by
    operand type, bytes read and written, the peak of live bytes with the
    arguments, the arguments' bytes, the collectives and the calls of each
    registered kernel."""

    flops: dict
    bytes_read: float
    bytes_written: float
    peak_bytes: int
    arg_bytes: int
    collectives: list
    kernels: dict
    notes: str = ""


def analyze(lowered: Lowered, mesh, model_flops: Optional[float] = None,
            loop_factor: float = 1.0) -> dict:
    """The record of one planned cell, with the reference's keys:

    * ``chips``: the ranks of ``mesh`` (a DeviceMesh or anything with
      ``.size()``);
    * ``hlo_gflops`` / ``hlo_gbytes``: rank 0's FLOPs and bytes read plus
      written, times ``loop_factor`` (a k-NN step stands for ``max_iters``
      iterations of its loop); ``gflops_bf16`` / ``gflops_fp32`` split the
      FLOPs by operand type;
    * ``collective_gbytes`` / ``collective_breakdown``: rank 0's network
      bytes (``collective_bytes``), not scaled by ``loop_factor``, as the
      reference's are not;
    * ``bytes_per_device``: rank 0's planned peak (live storages at their
      highest plus the arguments), ``arg_bytes_per_device`` the arguments'
      (``sharding.local_bytes``, rank 0 holding the largest block);
      ``fits_80gib`` when the peak fits the card;
    * ``t_compute_s`` / ``t_memory_s`` / ``t_collective_s``: the three
      terms at the rates above; ``dominant`` the largest,
      ``step_time_bound_s`` its time;
    * with ``model_flops`` (the whole job's useful FLOPs): ``useful_ratio``
      (model FLOPs per rank over counted FLOPs) and ``roofline_fraction``
      (the model FLOPs per rank at the peak of the step's main product type,
      bf16 where most FLOPs are bf16, else fp32, over the bound)."""
    chips = int(mesh.size())
    flops_by = {dt: f * loop_factor for dt, f in lowered.flops.items()}
    flops = sum(flops_by.values())
    byts = (lowered.bytes_read + lowered.bytes_written) * loop_factor
    coll = collective_bytes(lowered.collectives)
    t_compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS[torch.float32]) for dt, f in flops_by.items())
    t_memory = byts / HBM_BW
    t_coll = coll["_total"] / NET_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bf16 = flops_by.get(torch.bfloat16, 0.0)
    rec = {
        "chips": chips,
        "hlo_gflops": flops / 1e9,
        "gflops_bf16": bf16 / 1e9,
        "gflops_fp32": (flops - bf16) / 1e9,
        "hlo_gbytes": byts / 1e9,
        "collective_gbytes": coll["_total"] / 1e9,
        "collective_breakdown": {k: v for k, v in coll.items() if not k.startswith("_")},
        "bytes_per_device": int(lowered.peak_bytes),
        "arg_bytes_per_device": int(lowered.arg_bytes),
        "fits_80gib": lowered.peak_bytes <= HBM_BYTES,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
    }
    if model_flops:
        main = torch.bfloat16 if bf16 * 2 > flops else torch.float32
        rec["model_flops"] = model_flops
        rec["useful_ratio"] = model_flops / chips / max(flops, 1.0)
        rec["roofline_fraction"] = (model_flops / chips / PEAK_FLOPS[main]
                                    / max(max(terms.values()), 1e-30))
    return rec
