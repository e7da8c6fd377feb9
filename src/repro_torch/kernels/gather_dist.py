"""Gather + distance: the wrapper of ``csrc/gather_dist.cu`` and its plain
version (counterpart of ``repro.kernels.gather_dist``).

``gather_distance(q, x, idx)`` gives, for each query b, the distances to the
rows ``x[idx[b, :]]``, +inf where an id is negative; ``x`` is stored fp32,
bf16 or int8.  The CUDA kernel runs one warp per query, or per span of a
query's candidates where there are too few queries to fill the card, with
a chunk of the query's rows in flight at once, through the row routine the
fused expansion uses (``csrc/row_distance.cuh``).  Its plain version is
``kernels.ref.gather_distance``: the CPU path and the kernel's oracle.
``gather_floor`` launches an empty kernel at the gather's grid, the floor
of any timing of it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import metrics
from repro_torch.core.graph import squared_norms
from repro_torch.kernels import _cuda

# metric name -> the kernel's Metric enum (csrc/row_distance.cuh)
KERNEL_METRIC = {"l2": 0, "ip": 1, "cosine": 2, "l1": 4, "chi2": 5}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]
_MAX_WIDTH: dict = {}  # device -> max_width(device)


def kernel_operands(q, x, metric, sq_norms):
    """The query as the kernel takes it (pre-normalized for cosine, as the
    reference's wrapper does) and a norm cache that is always a tensor."""
    q = metrics.normalize_rows(q) if metric == "cosine" else q.float()
    if metric in ("l2", "cosine"):
        sq_norms = squared_norms(x) if sq_norms is None else sq_norms.float()
    else:
        sq_norms = torch.zeros(1, dtype=torch.float32, device=x.device)
    return q.contiguous(), sq_norms.contiguous()


def gather_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    metric: str = "l2",
    *,
    sq_norms: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: (b, d) float32, (n, d) table, (b, c) int32
    -> (b, c) float32.  CUDA tensors only.

    ``x`` is the raw float32 rows or an encoded table
    (``precision.EncodedData.data``): bfloat16, or int8 with its ``row_scale``
    table and the exact ``sq_norms`` cache.  Each storage type is its own
    instantiation of the kernel and counts its launches under its own name
    (``gather_distance``, ``gather_distance.bf16``, ``gather_distance.int8``).

    Each warp holds its query in shared memory, so d is at most
    ``max_width(x.device)``: the floats a CTA's shared memory may hold,
    58,112 on an H100.  A wider d raises ``ValueError``.  Runs through the
    registered operator ``repro_torch::gather_distance``.
    """
    return GATHER_OP(q, x, idx, sq_norms, row_scale, metric)


def gather_floor(
    q: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    metric: str = "l2",
    *,
    sq_norms: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> None:
    """Launch an empty kernel with the grid, block and shared memory that
    ``gather_distance`` would launch for the same arguments: the least time
    any gather can read under the same timer.  Not counted as a launch."""
    _launch("launch_gather_floor", q, x, idx, metric, sq_norms, row_scale, count=False)


def max_width(device: torch.device) -> int:
    """The widest d the CUDA kernel takes on ``device``: one query in the
    opt-in shared memory of a CTA, in whole 16-byte words."""
    if device not in _MAX_WIDTH:
        props = torch.cuda.get_device_properties(device)
        # an H100's 227 KB where this PyTorch does not report it
        optin = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
        _MAX_WIDTH[device] = optin // 16 * 4
    return _MAX_WIDTH[device]


def _launch(symbol, q, x, idx, metric, sq_norms, row_scale, *, count=True):
    code, name, scale = _cuda.table_operands("gather_distance", x, sq_norms, row_scale)
    if x.is_cuda and x.shape[1] > max_width(x.device):
        raise ValueError(f"gather_distance: d={x.shape[1]} is wider than the "
                         f"{max_width(x.device)} floats a CTA's shared memory holds")
    q, sq = kernel_operands(q, x, metric, sq_norms)
    idx = idx.to(torch.int32).contiguous()
    x = x.contiguous()
    B, C = idx.shape
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    _cuda.require_cuda("gather_distance", q, x, idx, sq, scale, out)
    fn = _cuda.function("gather_dist", symbol, _ARGTYPES)
    _cuda.launch(
        name, fn, x.device,
        _cuda.ptr(q), _cuda.ptr(x), _cuda.ptr(sq), _cuda.ptr(scale), _cuda.ptr(idx),
        _cuda.ptr(out), B, C, x.shape[1], KERNEL_METRIC[metric], code, count=count,
    )
    return out


def _real(q, x, idx, sq_norms, row_scale, metric):
    return _launch("launch_gather_distance", q, x, idx, metric, sq_norms, row_scale)


def _fake(q, x, idx, sq_norms, row_scale, metric):
    return q.new_empty(tuple(idx.shape), dtype=torch.float32)


def row_bytes(x: torch.Tensor, metric: str, row_scale) -> int:
    """Bytes the kernels read per candidate: its row of the table, its
    cached norm (l2, cosine) and its int8 scale."""
    out = x.shape[1] * x.element_size()
    if metric in ("l2", "cosine"):
        out += 4
    if row_scale is not None:
        out += 4
    return out


def cost(q, x, idx, sq_norms, row_scale, metric) -> dict:
    """One call from its shapes: 2·B·C·d fp32 FLOPs (a multiply and an add
    per element of each pair; the kernel widens every table type to fp32),
    the queries, the ids and every candidate's row read once (no dedupe of
    repeated ids), the (B, C) float32 result written once."""
    (B, C), d = idx.shape, x.shape[1]
    read = B * d * 4 + B * C * 4 + B * C * row_bytes(x, metric, row_scale)
    return _cuda.kernel_cost(2.0 * B * C * d, torch.float32, read, B * C * 4)


GATHER_OP = _cuda.register_op(
    "gather_distance",
    "(Tensor q, Tensor x, Tensor idx, Tensor? sq_norms, Tensor? row_scale, str metric) -> Tensor",
    _real, _fake, cost)
