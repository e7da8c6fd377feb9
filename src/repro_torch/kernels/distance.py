"""Tiled pairwise distances: the wrapper of ``csrc/distance.cu`` and its
plain version (counterpart of ``repro.kernels.distance``).

``pairwise_distance(q, x)`` gives the (m, n) float32 distances between two
row sets: the exact seed graph, the intra-wave W x W tile and the
brute-force ground truth all go through it.  The CUDA kernel is a
register-blocked SIMT GEMM (128x128 tiles, 8x8 per thread, persistent CTAs)
in full IEEE fp32 with a norm epilogue (``x_sq_norms``, the graph-resident
``‖x‖²`` cache, replaces the x-side norm reduction for l2); l1/chi2 run in
the same tiling.  Cosine normalizes both sides here and
takes ``1 − dot`` in the kernel.  Its plain version is
``kernels.ref.pairwise_distance``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import metrics
from repro_torch.kernels import _cuda

# metric name -> the kernel's PairMetric enum (csrc/distance.cu)
KERNEL_METRIC = {"l2": 0, "ip": 1, "cosine": 2, "l1": 3, "chi2": 4}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _P]


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    *,
    x_sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: (m, d) x (n, d) float32 -> (m, n) float32.
    CUDA tensors only."""
    if metric not in KERNEL_METRIC:
        raise KeyError(f"unknown metric {metric!r}; have {sorted(KERNEL_METRIC)}")
    if metric == "cosine":
        q, x = metrics.normalize_rows(q), metrics.normalize_rows(x)
    q, x = q.float().contiguous(), x.float().contiguous()
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    tensors = [q, x, out]
    xn = None
    if metric == "l2" and x_sq_norms is not None:
        xn = x_sq_norms.float().contiguous()
        tensors.append(xn)
    _cuda.require_cuda("pairwise_distance", *tensors)
    fn = _cuda.function("distance", "launch_pairwise_distance", _ARGTYPES)
    _cuda.launch(
        "pairwise_distance", fn, x.device,
        _cuda.ptr(q), _cuda.ptr(x), None if xn is None else _cuda.ptr(xn),
        _cuda.ptr(out), m, n, d, KERNEL_METRIC[metric],
    )
    return out
