"""int8 error-feedback gradient compression for the cross-pod reduction
(counterpart of ``repro.train.compress``).

    q = round(clip((g + e) / s, int8))     s = max|g + e| / 127  (per tensor)
    e' = (g + e) - s * q                   (residual carried to the next step)

``torch.round`` rounds half to even, as ``jnp.round`` does, and the order
is the reference's: divide, round, clip.  ``allreduce_compressed`` sums the
dequantized fp32 payloads over a ``torch.distributed`` group and divides by
its size, the reference's ``psum`` of ``q * s`` over the pod axis.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import distributed
from repro_torch.train.optimizer import tree_map

Tree = Any


def init_error_state(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 payload, f32 scale, new error residual)."""
    x = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(x)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - scale * q.float()
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def allreduce_compressed(grads: Tree, err: Tree, group=None) -> Tuple[Tree, Tree]:
    """Error-feedback compressed mean over ``group``: each rank contributes
    its int8-quantized (grad + residual), the dequantized payloads are
    summed in fp32 (through the host where a gloo group meets CUDA
    tensors).  Returns (mean grads, new residuals)."""
    n = distributed.world_size(group)

    def one(g, e):
        q, s, e2 = compress(g, e)
        total = distributed.all_reduce_sum(decompress(q, s), group)
        return (total / n).to(g.dtype), e2

    out = tree_map(one, grads, err)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
