"""Distance metrics (counterpart of ``repro.core.metrics``).

Smaller distance == closer.  ``l2`` is the squared euclidean distance in the
matmul expansion ``‖q‖² + ‖x‖² − 2 q·x`` clamped at 0; ``ip`` is the negative
inner product; ``cosine`` is ``1 − q̂·x̂``; ``l1`` and ``chi2`` are direct
reductions (``chi2`` assumes non-negative inputs, with 0/0 -> 0).

The metrics form a registry, as in the reference: ``register(name)`` adds a
``(q (..., m, d), x (..., n, d)) -> (..., m, n)`` float32 function, and every
plain version (brute force, the gather, the expansion, build and search)
then runs it on CPU tensors.  No CUDA kernel computes a registered metric:
``kernels.ops`` refuses one on a CUDA tensor before any launch.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

# Largest (rows, n, d-block) broadcast a direct reduction materializes at
# once; rows are processed in chunks below it (the result is row-wise, so the
# chunking does not change any value).
_BROADCAST_ELEMS = 1 << 24


def normalize_rows(a: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit l2 norm (norms clamped at 1e-12)."""
    a = a.float()
    return a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(1e-12)


def _t(a):
    return a.transpose(-1, -2)


# metric name -> pairwise function of float32 operands
_REGISTRY: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {}


def register(name: str):
    """Decorator adding a pairwise function under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def names() -> list:
    return sorted(_REGISTRY)


@register("l2")
def _l2(q, x):
    qn = (q * q).sum(-1, keepdim=True)
    xn = _t((x * x).sum(-1, keepdim=True))
    return (qn + xn - 2.0 * (q @ _t(x))).clamp_min(0.0)


@register("ip")
def _ip(q, x):
    return -(q @ _t(x))


@register("cosine")
def _cosine(q, x):
    return 1.0 - normalize_rows(q) @ _t(normalize_rows(x))


def _l1_term(qq, xx):
    return (qq - xx).abs()


def _chi2_term(qq, xx):
    num = (qq - xx) ** 2
    den = qq + xx
    return torch.where(den > 1e-12, num / den.clamp_min(1e-12), 0.0)


def _direct(term, q, x):
    """sum_d term(q_d, x_d) in feature blocks of 128 (as the JAX scan)."""
    *batch, m, d = q.shape
    n = x.shape[-2]
    block = 128 if d > 128 else d
    out = torch.zeros((*batch, m, n), dtype=torch.float32, device=q.device)
    rows = max(1, _BROADCAST_ELEMS // max(1, out[..., :1, :].numel() * block))
    for r0 in range(0, m, rows):
        qr = q[..., r0:r0 + rows, :]
        acc = out[..., r0:r0 + rows, :]
        for j in range(0, d, block):
            acc += term(qr[..., :, None, j:j + block], x[..., None, :, j:j + block]).sum(-1)
    return out


_ROW_TERMS = {"l1": _l1_term, "chi2": _chi2_term}


@register("l1")
def _l1(q, x):
    return _direct(_l1_term, q, x)


@register("chi2")
def _chi2(q, x):
    return _direct(_chi2_term, q, x)


def pairwise(metric: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, d) queries x (..., n, d) points -> (..., m, n) float32
    distances; leading dims are a batch of independent products."""
    if metric not in _REGISTRY:
        raise KeyError(f"unknown metric {metric!r}; have {names()}")
    return _REGISTRY[metric](q.float(), x.float())


def one_to_many(metric: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(d,) query vs (n, d) points -> (n,) distances."""
    return pairwise(metric, q[None, :], x)[0]


def is_matmul_metric(metric: str) -> bool:
    """True when the metric reduces to a product (the tensor-core metrics)."""
    return metric in ("l2", "ip", "cosine")


def row_terms(metric: str, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Metrics with no product form between q (b, d) and its rows cand
    (b, c, d) -> (b, c): l1 and chi2 by their terms, any other registered
    metric by its pairwise function with each query as its own batch of one
    row (the reference's per-query ``pairwise``).  Unknown names raise
    ``KeyError``."""
    term = _ROW_TERMS.get(metric)
    if term is not None:
        return term(q.float()[:, None, :], cand.float()).sum(-1)
    return pairwise(metric, q[:, None, :], cand)[:, 0, :]
