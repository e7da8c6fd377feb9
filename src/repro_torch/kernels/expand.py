"""Fused EHC expansion step: the wrapper of ``csrc/expand.cu``, its plain
version ``expand_reference`` and the hash/beam primitives both follow
(counterpart of ``repro.kernels.expand``).

One EHC iteration per query lane: classify the candidate ids against the
lane's visited hash (the paper's D array), compute distances to the fresh
ones, record them, and merge them into the beam top-e.  Returns
``(beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, comps)``.  The
kernel's distances read the table it is given, as ``gather_dist``'s do: the
float32 rows, or a bf16 or int8 one (with its ``row_scale``); the plain
version takes the compressed table as ``enc``/``precision``, as
``ref.gather_distance`` does.  PQ never reaches this layer.

Both the kernel and the plain version update the visited hash ``vis_ids`` /
``vis_dist`` IN PLACE and return the same tensors: the kernel touches only
the probed slots in device memory, which works for any H, and the plain
version writes only the recorded slots.  Callers that need the old table
clone it first.

Tie and collision rules, shared by both and taken from the reference:
  * every candidate is classified against the table as it stood before the
    step (batch-classify-then-scatter);
  * candidates that take the same slot: the later one in candidate order
    wins (XLA's scatter order for the reference's ``.at[].set``), elected
    explicitly, never left to a device's duplicate-index order;
  * the beam is the top-e of (beam ‖ candidates) in IEEE total order with
    ties to the lower position (``lax.top_k``), then later copies of an id
    are masked.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import segments
from repro_torch.kernels import _cuda, ref
from repro_torch.kernels import gather_dist as _gather
from repro_torch.kernels.gather_dist import KERNEL_METRIC, kernel_operands
from repro_torch.kernels.precision import EncodedData

_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def probe_slots(ids: torch.Tensor, hash_slots: int, probes: int) -> torch.Tensor:
    """(...,) ids -> (..., P) int64 linear-probe slots of the Knuth hash.

    The reference multiplies in uint32 with wraparound; int64 arithmetic
    masked to 32 bits gives the same slots exactly."""
    h = ((ids.long() & _MASK32) * _KNUTH) & _MASK32
    h = (h >> 16) & (hash_slots - 1)
    p = torch.arange(probes, dtype=torch.int64, device=ids.device)
    return (h[..., None] + p) & (hash_slots - 1)


def _probe(vis_ids: torch.Tensor, ids: torch.Tensor, probes: int):
    B, H = vis_ids.shape
    C = ids.shape[1]
    slots = probe_slots(ids, H, probes)  # (B, C, P)
    got = torch.gather(vis_ids, 1, slots.reshape(B, C * probes)).reshape(B, C, probes)
    return slots, got


def hash_lookup(vis_ids, vis_dist, ids, probes: int):
    """(found (B, C) bool, dist (B, C) float32, +inf where not found)."""
    B, C = ids.shape
    slots, got = _probe(vis_ids, ids, probes)
    got_d = torch.gather(vis_dist, 1, slots.reshape(B, -1)).reshape(B, C, probes)
    hit = got == ids[..., None]
    dist = torch.where(hit, got_d, float("inf")).amin(dim=-1)
    return hit.any(dim=-1), dist


def hash_probe_state(vis_ids: torch.Tensor, ids: torch.Tensor, probes: int):
    """Classify ids against the tables: (present, insert_ok, insert_slot)."""
    slots, got = _probe(vis_ids, ids, probes)
    hit, empty = got == ids[..., None], got == -1
    # first probe index that hits / is empty (P when none); a short loop over
    # the P probes runs far faster on the CPU than a min over a length-P axis
    first_hit = torch.full(ids.shape, probes, dtype=torch.int64, device=ids.device)
    first_empty = first_hit.clone()
    for p in range(probes - 1, -1, -1):
        first_hit = torch.where(hit[..., p], p, first_hit)
        first_empty = torch.where(empty[..., p], p, first_empty)
    present = first_hit < first_empty
    insert_ok = ~present & (first_empty < probes)
    insert_slot = torch.gather(
        slots, 2, first_empty.clamp_max(probes - 1)[..., None]
    )[..., 0]
    return present, insert_ok, insert_slot


def record(
    vis_ids: torch.Tensor,
    vis_dist: torch.Tensor,
    ids: torch.Tensor,
    dists: torch.Tensor,
    do_ins: torch.Tensor,
    slot: torch.Tensor,
) -> None:
    """Write (ids, dists) where ``do_ins`` into their slots, in place.  Of the
    entries sharing a slot in one row, the last in column order wins.  The
    write is a whole-tensor scatter (``segments.scatter_rows``), so no shape
    depends on the data."""
    B, C = ids.shape
    H = vis_ids.shape[1]
    later = torch.triu(torch.ones(C, C, dtype=torch.bool, device=ids.device), 1)
    same = (slot[:, :, None] == slot[:, None, :]) & do_ins[:, None, :] & later
    win = do_ins & ~same.any(dim=2)
    flat = torch.arange(B, device=ids.device)[:, None] * H + slot
    zero = torch.zeros_like(flat)
    for table, values in ((vis_ids, ids), (vis_dist, dists)):
        written = segments.scatter_rows(
            table.reshape(-1, 1), flat.reshape(-1), zero.reshape(-1), values.reshape(-1),
            win.reshape(-1))
        table.copy_(written.reshape(B, H))


def dedupe_beam(ids, dist, exp):
    """Mask later copies of duplicate beam ids: (-1, +inf, expanded)."""
    e = ids.shape[1]
    earlier = torch.triu(torch.ones(e, e, dtype=torch.bool, device=ids.device), 1)
    eq = (ids[:, None, :] == ids[:, :, None]) & (ids[:, None, :] >= 0) & earlier
    dup = eq.any(dim=1)
    return (
        torch.where(dup, -1, ids),
        torch.where(dup, float("inf"), dist),
        exp | dup,
    )


def _probe_mask_record_merge(
    cands, dists_all, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, probes
):
    """Everything downstream of the distance gather: classify, count,
    record (in place), merge, dedupe."""
    e = beam_ids.shape[1]
    present, insert_ok, insert_slot = hash_probe_state(vis_ids, cands, probes)
    fresh = (cands >= 0) & ~present
    cand_ids = torch.where(fresh, cands, -1).to(torch.int32)
    dists = torch.where(fresh, dists_all, float("inf"))
    comps = fresh.sum(dim=1).to(torch.int32)
    record(vis_ids, vis_dist, cand_ids, dists, fresh & insert_ok, insert_slot)
    cat_ids = torch.cat([beam_ids, cand_ids], dim=1)
    cat_dist = torch.cat([beam_dist, dists], dim=1)
    cat_exp = torch.cat([beam_exp, cand_ids < 0], dim=1)
    sel = torch.sort(ref.sort_key(cat_dist), dim=1, stable=True).indices[:, :e]
    beam_ids, beam_dist, beam_exp = dedupe_beam(
        torch.gather(cat_ids, 1, sel),
        torch.gather(cat_dist, 1, sel),
        torch.gather(cat_exp, 1, sel),
    )
    return beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, comps


def expand_reference(
    q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
    *, metric: str = "l2", probes: int = 8, sq_norms: Optional[torch.Tensor] = None,
    enc: Optional[EncodedData] = None, precision: str = "fp32",
):
    """The plain version of ``fused_expand`` (same returns); the table is
    ``x`` or, for bf16/int8, ``enc``."""
    if precision == "pq":
        # only exact distances may enter the hash and the beam; the ADC
        # prerank composes one layer up, in kernels.ops.expand_step
        raise ValueError("the expansion takes fp32/bf16/int8; pq is an ops-level prerank")
    present, _, _ = hash_probe_state(vis_ids, cands, probes)
    fresh_ids = torch.where((cands >= 0) & ~present, cands, -1)
    dists = ref.gather_distance(
        q, x, fresh_ids, metric, sq_norms=sq_norms, enc=enc, precision=precision
    )
    return _probe_mask_record_merge(
        cands, dists, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, probes
    )


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I] * 8 + [_P]


def fused_expand(
    q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
    *, metric: str = "l2", probes: int = 8, sq_norms: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
):
    """Launch the CUDA kernel (one warp per lane, eight lanes per CTA).
    CUDA tensors only; the hash tensors must be contiguous int32/float32 and
    are updated in place.

    ``x`` is the candidate table as ``gather_dist.gather_distance`` takes it:
    float32 rows, or bfloat16, or int8 with its ``row_scale`` table and the
    exact ``sq_norms`` cache.  Each storage type is its own instantiation of
    the kernel, counted under its own name (``fused_expand``,
    ``fused_expand.bf16``, ``fused_expand.int8``).  Runs through the
    registered operator ``repro_torch::fused_expand``, which declares the
    hash as written."""
    if vis_ids.dtype != torch.int32 or vis_dist.dtype != torch.float32:
        raise ValueError("fused_expand: the hash is (int32 ids, float32 dists)")
    out_ids, out_dist, out_exp, comps = EXPAND_OP(
        q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, sq_norms, row_scale,
        metric, probes)
    return out_ids, out_dist, out_exp, vis_ids, vis_dist, comps


def _launch(q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, sq_norms,
            row_scale, metric, probes):
    """The operator's CUDA implementation: launch the kernel; returns
    (beam ids, dists, expanded flags, comps), the hash written in place."""
    code, name, scale = _cuda.table_operands("fused_expand", x, sq_norms, row_scale)
    q, sq = kernel_operands(q, x, metric, sq_norms)
    x = x.contiguous()
    cands = cands.to(torch.int32).contiguous()
    beam_ids = beam_ids.to(torch.int32).contiguous()
    beam_dist = beam_dist.float().contiguous()
    beam_exp = beam_exp.to(torch.bool).contiguous()
    B, C = cands.shape
    e = beam_ids.shape[1]
    H = vis_ids.shape[1]
    if H & (H - 1):
        raise ValueError(f"fused_expand: hash_slots must be a power of two, got {H}")
    out_ids = torch.empty_like(beam_ids)
    out_dist = torch.empty_like(beam_dist)
    out_exp = torch.empty_like(beam_exp)
    comps = torch.empty(B, dtype=torch.int32, device=x.device)
    tensors = (q, x, sq, scale, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
               out_ids, out_dist, out_exp, comps)
    _cuda.require_cuda("fused_expand", *tensors)
    fn = _cuda.function("expand", "launch_fused_expand", _ARGTYPES)
    _cuda.launch(
        name, fn, x.device, *(_cuda.ptr(t) for t in tensors),
        B, C, e, H, probes, x.shape[1], KERNEL_METRIC[metric], code,
    )
    return out_ids, out_dist, out_exp, comps


def _fake(q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, sq_norms,
          row_scale, metric, probes):
    B, e = beam_ids.shape
    return (beam_ids.new_empty((B, e), dtype=torch.int32),
            beam_dist.new_empty((B, e), dtype=torch.float32),
            beam_exp.new_empty((B, e), dtype=torch.bool),
            cands.new_empty((B,), dtype=torch.int32))


def cost(q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, sq_norms,
         row_scale, metric, probes) -> dict:
    """One call from its shapes: 2·B·C·d fp32 FLOPs for the candidates'
    distances (the hash and the beam merge are not counted as FLOPs); read
    once each: the queries, the candidate ids, every candidate's row (no
    dedupe), the P probed hash slots of every candidate (ids and dists) and
    the beam; written once each: a hash slot (id and dist) per candidate,
    the new beam and the comparison counts."""
    (B, C), d, e = cands.shape, x.shape[1], beam_ids.shape[1]
    beam = B * e * (4 + 4 + 1)
    read = (B * d * 4 + B * C * 4 + B * C * _gather.row_bytes(x, metric, row_scale)
            + B * C * probes * 8 + beam)
    written = B * C * 8 + beam + B * 4
    return _cuda.kernel_cost(2.0 * B * C * d, torch.float32, read, written)


EXPAND_OP = _cuda.register_op(
    "fused_expand",
    "(Tensor q, Tensor x, Tensor cands, Tensor beam_ids, Tensor beam_dist, Tensor beam_exp, "
    "Tensor(a!) vis_ids, Tensor(b!) vis_dist, Tensor? sq_norms, Tensor? row_scale, str metric, "
    "int probes) -> (Tensor, Tensor, Tensor, Tensor)",
    _launch, _fake, cost)
