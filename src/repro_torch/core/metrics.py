"""Distance metrics (counterpart of ``repro.core.metrics``).

Smaller distance == closer.  ``l2`` is the squared euclidean distance in the
matmul expansion ``‖q‖² + ‖x‖² − 2 q·x`` clamped at 0; ``ip`` is the negative
inner product; ``cosine`` is ``1 − q̂·x̂``; ``l1`` and ``chi2`` are direct
reductions (``chi2`` assumes non-negative inputs, with 0/0 -> 0).
"""

from __future__ import annotations

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


def _l2(q, x):
    qn = (q * q).sum(-1, keepdim=True)
    xn = _t((x * x).sum(-1, keepdim=True))
    return (qn + xn - 2.0 * (q @ _t(x))).clamp_min(0.0)


def _ip(q, x):
    return -(q @ _t(x))


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


_PAIRWISE = {
    "l2": _l2,
    "ip": _ip,
    "cosine": _cosine,
    "l1": lambda q, x: _direct(_l1_term, q, x),
    "chi2": lambda q, x: _direct(_chi2_term, q, x),
}


def pairwise(metric: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, d) queries x (..., n, d) points -> (..., m, n) float32
    distances; leading dims are a batch of independent products."""
    if metric not in _PAIRWISE:
        raise KeyError(f"unknown metric {metric!r}; have {sorted(_PAIRWISE)}")
    return _PAIRWISE[metric](q.float(), x.float())


def row_terms(metric: str, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Direct-reduction metrics between q (b, d) and its rows cand (b, c, d)."""
    term = _l1_term if metric == "l1" else _chi2_term
    return term(q.float()[:, None, :], cand.float()).sum(-1)
