"""The running top-k of one exact k-NN tile: the wrapper of
``csrc/tile_topk.cu``.

``tile_topk(dt, best_d, best_i, lo, n_valid)`` folds a tile of distances
into each query row's running best: the k smallest of the k running entries
followed by the tile's T entries (ids ``lo .. lo + T - 1``), ascending by
``ref.sort_key``'s total order with ties to the lower column, tile entries
that fail the mask (id ≥ ``n_valid``, not ``alive``, the row's
``exclude_ids``) at +inf with their own ids.  ``core.brute`` calls it once a
tile.  The CUDA kernel runs one warp per query row (Faiss's warp select,
the list's length a power of two picked from k); it replaces no TPU kernel:
the reference's top-k is ``lax.top_k``.  Its plain version is
``kernels.ref.tile_topk``, which it equals bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _cuda

# the longest running list the kernel keeps (csrc/tile_topk.cu)
MAX_K = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 4 + [ctypes.c_longlong, _I, _P]


def tile_topk(
    dt: torch.Tensor,
    best_d: torch.Tensor,
    best_i: torch.Tensor,
    lo: int,
    n_valid: int,
    *,
    alive: Optional[torch.Tensor] = None,
    exclude_ids: Optional[torch.Tensor] = None,
):
    """Launch the CUDA kernel: ``dt`` (m, T) float32, ``best_d`` (m, k)
    float32 and ``best_i`` (m, k) int32 -> the new (best_d, best_i).
    ``alive`` is the tile's slice of the alive flags (bool, at most T long:
    columns past it are dead), ``exclude_ids`` (m,) one id per row.  CUDA
    tensors only; k above ``MAX_K`` raises ``ValueError``.  Runs through the
    registered operator ``repro_torch::tile_topk``."""
    return TILE_TOPK_OP(dt, best_d, best_i, alive, exclude_ids, lo, n_valid)


def _real(dt, best_d, best_i, alive, exclude_ids, lo, n_valid):
    m, T = dt.shape
    k = best_d.shape[1]
    if k > MAX_K:
        raise ValueError(f"tile_topk: k={k} is above the {MAX_K} the kernel keeps")
    if dt.dtype != torch.float32 or best_d.dtype != torch.float32 or best_i.dtype != torch.int32:
        raise ValueError("tile_topk: needs float32 distances and int32 ids, got "
                         f"{dt.dtype}, {best_d.dtype}, {best_i.dtype}")
    if tuple(best_d.shape) != (m, k) or tuple(best_i.shape) != (m, k):
        raise ValueError(f"tile_topk: best {tuple(best_d.shape)} / {tuple(best_i.shape)} "
                         f"for a tile of {m} rows")
    if alive is not None and (alive.dtype != torch.bool or alive.dim() != 1 or alive.shape[0] > T):
        raise ValueError("tile_topk: alive must be a bool slice of at most T columns")
    if exclude_ids is not None:
        if tuple(exclude_ids.shape) != (m,):
            raise ValueError(f"tile_topk: exclude_ids {tuple(exclude_ids.shape)} for {m} rows")
        exclude_ids = exclude_ids.to(torch.int64)
    dt, best_d, best_i = dt.contiguous(), best_d.contiguous(), best_i.contiguous()
    alive = None if alive is None else alive.contiguous()
    exclude_ids = None if exclude_ids is None else exclude_ids.contiguous()
    out_d = torch.empty((m, k), dtype=torch.float32, device=dt.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dt.device)
    _cuda.require_cuda("tile_topk", dt, best_d, best_i, alive, exclude_ids, out_d, out_i)
    if m == 0 or k == 0:
        return out_d, out_i
    fn = _cuda.function("tile_topk", "launch_tile_topk", _ARGTYPES)
    _cuda.launch(
        "tile_topk", fn, dt.device,
        _cuda.ptr(dt), _cuda.ptr(best_d), _cuda.ptr(best_i), _cuda.ptr(alive),
        _cuda.ptr(exclude_ids), _cuda.ptr(out_d), _cuda.ptr(out_i), m, T, k, int(lo),
        int(n_valid), 0 if alive is None else alive.shape[0],
    )
    return out_d, out_i


def _fake(dt, best_d, best_i, alive, exclude_ids, lo, n_valid):
    m, k = dt.shape[0], best_d.shape[1]
    return (dt.new_empty((m, k), dtype=torch.float32), dt.new_empty((m, k), dtype=torch.int32))


def cost(dt, best_d, best_i, alive, exclude_ids, lo, n_valid) -> dict:
    """One call from its shapes: no FLOPs (compares only); the tile read once
    (m·T·4), the running best read and the new one written (m·k·8 each), the
    alive slice (a byte a column) and the excluded ids (8 bytes a row)."""
    m, T = dt.shape
    k = best_d.shape[1]
    read = m * T * 4 + m * k * 8
    if alive is not None:
        read += alive.shape[0]
    if exclude_ids is not None:
        read += m * 8
    return _cuda.kernel_cost(0.0, torch.float32, read, m * k * 8)


TILE_TOPK_OP = _cuda.register_op(
    "tile_topk",
    "(Tensor dt, Tensor best_d, Tensor best_i, Tensor? alive, Tensor? exclude_ids, int lo, "
    "int n_valid) -> (Tensor, Tensor)",
    _real, _fake, cost)
