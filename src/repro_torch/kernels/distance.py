"""Tiled pairwise distances: the wrappers of ``csrc/distance.cu`` (and
``distance_bf16.cu``, both entries of the kernel in ``distance.cuh``) and of
``csrc/distance_wgmma.cu``, and their plain version (counterpart of
``repro.kernels.distance``).

``pairwise_distance(q, x)`` gives the (m, n) float32 distances between two
row sets: the exact seed graph, the intra-wave W x W tile and the
brute-force ground truth all go through it.  The CUDA kernel is a
register-blocked SIMT GEMM (128x128 tiles, 8x8 per thread, persistent CTAs)
in full IEEE fp32 with a norm epilogue (``x_sq_norms``, the graph-resident
``‖x‖²`` cache, replaces the x-side norm reduction for l2); l1/chi2 run in
the same tiling.  Cosine normalizes both sides here and
takes ``1 − dot`` in the kernel.  Two bfloat16 operands (a ``data_bf16``
build) take one of two forms, chosen by ``bf16_form``: l2 and ip at
``d % 8 == 0`` on 16-byte aligned rows run the tensor-core kernel
(``wgmma``, fp32 sums in the tensor cores' order; norms and epilogue as the
SIMT kernel's), everything else the SIMT kernel's bf16-operand
instantiation, which widens its loads in registers and is otherwise the
fp32 kernel.  Other mixes are widened to fp32 here.  Its plain version is
``kernels.ref.pairwise_distance``, which widens every operand.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import metrics
from repro_torch.kernels import _cuda

# metric name -> the kernel's PairMetric enum (csrc/distance.cu)
KERNEL_METRIC = {"l2": 0, "ip": 1, "cosine": 2, "l1": 3, "chi2": 4}

# bf16 operands: the metrics that are a product, which the tensor-core
# form takes
WGMMA_METRICS = ("l2", "ip")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _P]


def bf16_form(metric: str, d: int, aligned: bool) -> str:
    """The kernel two bfloat16 operands take: ``"wgmma"`` (the tensor-core
    form, ``csrc/distance_wgmma.cu``) for l2 and ip at ``d % 8 == 0`` with
    both operands 16-byte aligned (TMA addresses whole 16-byte rows), else
    ``"simt"`` (``csrc/distance_bf16.cu``).  Cosine never asks: it
    normalizes in fp32 and takes the fp32 kernel."""
    return "wgmma" if metric in WGMMA_METRICS and d % 8 == 0 and aligned else "simt"


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    *,
    x_sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch a CUDA kernel: (m, d) x (n, d) -> (m, n) float32, both
    operands bfloat16 (counted as ``pairwise_distance.bf16``, and the
    tensor-core form also as ``pairwise_distance.bf16_wgmma``) or else
    widened to float32.  CUDA tensors only; a form that fails to build or
    launch raises, and nothing falls back to another.  Runs through the
    registered operator ``repro_torch::pairwise_distance``."""
    return PAIRWISE_OP(q, x, x_sq_norms, metric)


def _launch(q: torch.Tensor, x: torch.Tensor, x_sq_norms: Optional[torch.Tensor],
            metric: str) -> torch.Tensor:
    """The operator's CUDA implementation: choose the form, launch it."""
    if metric == "cosine":
        q, x = metrics.normalize_rows(q), metrics.normalize_rows(x)
    if q.dtype == x.dtype == torch.bfloat16:
        q, x = q.contiguous(), x.contiguous()
        aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
        if bf16_form(metric, q.shape[1], aligned) == "wgmma":
            return _pairwise_wgmma(q, x, metric, x_sq_norms)
        name, lib, symbol = "pairwise_distance.bf16", "distance_bf16", "launch_pairwise_distance_bf16"
    else:
        name, lib, symbol = "pairwise_distance", "distance", "launch_pairwise_distance"
        q, x = q.float(), x.float()
    q, x = q.contiguous(), x.contiguous()
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    tensors = [q, x, out]
    xn = None
    if metric == "l2" and x_sq_norms is not None:
        xn = x_sq_norms.float().contiguous()
        tensors.append(xn)
    _cuda.require_cuda("pairwise_distance", *tensors)
    fn = _cuda.function(lib, symbol, _ARGTYPES)
    _cuda.launch(
        name, fn, x.device,
        _cuda.ptr(q), _cuda.ptr(x), None if xn is None else _cuda.ptr(xn),
        _cuda.ptr(out), m, n, d, KERNEL_METRIC[metric],
    )
    return out


def _pairwise_wgmma(q, x, metric, x_sq_norms):
    """The tensor-core form on contiguous, aligned bf16 rows."""
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    xn = None
    if metric == "l2" and x_sq_norms is not None:
        xn = x_sq_norms.float().contiguous()
    _cuda.require_cuda("pairwise_distance", q, x, out, xn)
    fn = _cuda.function("distance_wgmma", "launch_pairwise_distance_wgmma", _ARGTYPES)
    _cuda.launch(
        ("pairwise_distance.bf16", "pairwise_distance.bf16_wgmma"), fn, x.device,
        _cuda.ptr(q), _cuda.ptr(x), _cuda.ptr(xn), _cuda.ptr(out), m, n, d, KERNEL_METRIC[metric],
    )
    return out


def _fake(q, x, x_sq_norms, metric):
    return q.new_empty((q.shape[0], x.shape[0]), dtype=torch.float32)


def cost(q, x, x_sq_norms, metric) -> dict:
    """One call from its shapes: 2·m·n·d FLOPs (the tile's products and
    sums; the norm epilogue is not counted), charged at bf16 for the
    tensor-core form (two bf16 operands under l2 or ip at d % 8 == 0, rows
    taken as aligned) and at fp32 otherwise; both operands, the norm cache
    and the (m, n) float32 result each move once."""
    (m, d), n = q.shape, x.shape[0]
    bf16 = q.dtype == x.dtype == torch.bfloat16 and bf16_form(metric, d, True) == "wgmma"
    read = m * d * q.element_size() + n * d * x.element_size()
    if metric == "l2" and x_sq_norms is not None:
        read += n * 4
    return _cuda.kernel_cost(2.0 * m * n * d, torch.bfloat16 if bf16 else torch.float32,
                             read, m * n * 4)


PAIRWISE_OP = _cuda.register_op(
    "pairwise_distance", "(Tensor q, Tensor x, Tensor? x_sq_norms, str metric) -> Tensor",
    _launch, _fake, cost)
