"""The one routing point between the CUDA kernels and their plain versions
(counterpart of ``repro.kernels.ops``).

The tensor's device decides, and nothing else: a tensor on the CPU takes the
plain PyTorch version; a tensor on a CUDA device takes the hand-written
kernel, which launches or raises.  There is no engine option and no
fallback.  Callers in ``repro_torch.core`` reach the kernels only through
these functions, by module attribute (``ops.expand_step(...)``).

Launch counts: ``launch_counts()`` reads, and ``reset_launch_counts()``
zeroes, the per-kernel integers the wrappers bump where they launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.kernels import distance as _distance
from repro_torch.kernels import expand as _expand
from repro_torch.kernels import gather_dist as _gather_dist


def launch_counts() -> dict:
    return dict(_cuda.LAUNCHES)


def reset_launch_counts() -> None:
    _cuda.reset_launches()


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    *,
    x_sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) float32 distances."""
    if x.is_cuda:
        return _distance.pairwise_distance(q, x, metric, x_sq_norms=x_sq_norms)
    return ref.pairwise_distance(q, x, metric, x_sq_norms=x_sq_norms)


def gather_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    metric: str = "l2",
    *,
    sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(b, d) queries vs rows x[idx] -> (b, c) float32; +inf at idx < 0."""
    if x.is_cuda:
        return _gather_dist.gather_distance(q, x, idx, metric, sq_norms=sq_norms)
    return ref.gather_distance(q, x, idx, metric, sq_norms=sq_norms)


def expand_step(
    q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
    *, metric: str = "l2", hash_probes: int = 8, sq_norms: Optional[torch.Tensor] = None,
):
    """One EHC expansion step; see ``kernels.expand``.  The visited hash is
    updated in place."""
    fn = _expand.fused_expand if x.is_cuda else _expand.expand_reference
    return fn(
        q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
        metric=metric, probes=hash_probes, sq_norms=sq_norms,
    )

