"""Compressed candidate tables for the distance engine (counterpart of
``repro.kernels.precision``).

One ``precision`` vocabulary for the whole port:

* ``"fp32"``: no encoding; the engine reads the raw rows.
* ``"bf16"``: rows stored bfloat16 (2 bytes/dim), widened to fp32 at the
  reduction; accumulation is always fp32.
* ``"int8"``: symmetric per-row codes ``x8 = round(x / s)``, ``s = max|x| /
  127`` (the graph's ``row_scale`` cache).  The engine applies ``s`` to the
  dot product for l2/ip/cosine, so the exact cached ``‖x‖²`` keeps the norm
  term exact; for l1/chi2 it dequantizes each element.
* ``"pq"``: product-quantization codes (M bytes/row) for a first-pass rank
  by asymmetric distance (ADC); the survivors are re-ranked with exact fp32
  distances (``kernels.ops.expand_step``).

ADC covers l2 (squared), ip, l1 and chi2 as sums of per-subspace terms;
cosine takes the dot table and divides by the exact cached norms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import row_scales

PRECISIONS = ("fp32", "bf16", "int8", "pq")

# PQ: dsub dims per subspace (M = d / dsub), K centroids per subspace (uint8
# codes); a d not divisible by _PQ_DSUB takes its largest divisor below it.
_PQ_DSUB = 8
_PQ_K = 256
_PQ_TRAIN_SAMPLE = 2048
_PQ_TRAIN_ITERS = 8

# Largest (rows, M, K) fp32 block ``pq_encode`` materializes at once (64 MB).
_ENCODE_ELEMS = 1 << 24


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


class EncodedData(NamedTuple):
    """Compressed companion of a dataset.  Fields set, by precision:

    * bf16: ``data`` (n, d) bfloat16;
    * int8: ``data`` (n, d) int8 and ``scale`` (n,) float32;
    * pq:   ``codes`` (n, M) uint8 and ``codebook`` (M, K, dsub) float32.
    """

    data: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    codebook: Optional[torch.Tensor] = None

    def to(self, device) -> "EncodedData":
        return EncodedData(*(None if t is None else t.to(device) for t in self))


def pq_subspaces(d: int) -> int:
    """Number of PQ subspaces for dimension d (largest dsub <= _PQ_DSUB)."""
    for dsub in range(min(_PQ_DSUB, d), 0, -1):
        if d % dsub == 0:
            return d // dsub
    return d


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(n, d) rows, (n,) scales -> (n, d) int8 codes, rounding half to even.
    Zero scales quantize through 1, as the engine's dequantization does."""
    safe = torch.where(scale > 0, scale.float(), 1.0)[:, None]
    return torch.round(x.float() / safe).clamp(-127, 127).to(torch.int8)


def train_pq_codebook(x: torch.Tensor) -> torch.Tensor:
    """Per-subspace centroids from a few Lloyd iterations over the first
    ``_PQ_TRAIN_SAMPLE`` rows, started from strided rows; deterministic.
    Empty clusters keep their centroid.  Returns (M, K, dsub) float32."""
    d = x.shape[1]
    M = pq_subspaces(d)
    dsub = d // M
    ns = min(x.shape[0], _PQ_TRAIN_SAMPLE)
    sub = x[:ns].float().reshape(ns, M, dsub).transpose(0, 1).contiguous()  # (M, ns, dsub)
    init = ((torch.arange(_PQ_K, device=x.device) * ns) // _PQ_K).clamp(0, ns - 1)
    cb = sub[:, init, :]  # (M, K, dsub)
    xn = (sub * sub).sum(-1, keepdim=True)  # (M, ns, 1)
    for _ in range(_PQ_TRAIN_ITERS):
        cn = (cb * cb).sum(-1)[:, None, :]  # (M, 1, K)
        assign = torch.argmin(xn + cn - 2.0 * torch.bmm(sub, cb.transpose(1, 2)), dim=-1)
        onehot = torch.nn.functional.one_hot(assign, _PQ_K).float()  # (M, ns, K)
        counts = onehot.sum(1)  # (M, K)
        new = torch.bmm(onehot.transpose(1, 2), sub) / counts.clamp_min(1.0)[:, :, None]
        cb = torch.where((counts > 0)[:, :, None], new, cb)
    return cb


def pq_encode(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(n, d) rows -> (n, M) uint8 nearest-centroid codes.  Row chunks keep
    the (rows, M, K) scores near 64 MB; each row's code is its own."""
    M, K, dsub = codebook.shape
    n = x.shape[0]
    cb = codebook.float()
    cn = (cb * cb).sum(-1)  # (M, K); ‖x_m‖² is constant per row, argmin ignores it
    out = torch.empty((n, M), dtype=torch.uint8, device=x.device)
    rows = max(1, _ENCODE_ELEMS // (M * K))
    for r0 in range(0, n, rows):
        sub = x[r0:r0 + rows].float().reshape(-1, M, dsub).transpose(0, 1)  # (M, r, dsub)
        dots = torch.bmm(sub, cb.transpose(1, 2)).transpose(0, 1)  # (r, M, K)
        out[r0:r0 + rows] = torch.argmin(cn[None] - 2.0 * dots, dim=-1).to(torch.uint8)
    return out


def encode_dataset(
    x: torch.Tensor,
    precision: str,
    *,
    row_scale: Optional[torch.Tensor] = None,
    codebook: Optional[torch.Tensor] = None,
) -> Optional[EncodedData]:
    """The engine's compressed table for ``x``; None for fp32.

    ``row_scale`` reuses the graph's int8 scale cache (derived from ``x``
    when absent); pq encodes with ``codebook`` (a pinned code space), else
    trains one on ``x``."""
    validate_precision(precision)
    if precision == "fp32":
        return None
    if precision == "bf16":
        return EncodedData(data=x.to(torch.bfloat16))
    if precision == "int8":
        scale = row_scales(x) if row_scale is None else row_scale.float()
        return EncodedData(data=quantize_int8(x, scale), scale=scale)
    if codebook is None:
        codebook = train_pq_codebook(x)
    return EncodedData(codes=pq_encode(x, codebook), codebook=codebook)


def adc_tables(q: torch.Tensor, codebook: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, d) queries -> (B, M, K) per-subspace ADC lookup tables; cosine
    gets the dot table (the caller divides by the cached norms)."""
    B = q.shape[0]
    M, K, dsub = codebook.shape
    qs = q.float().reshape(B, M, dsub)
    cb = codebook.float()
    if metric in ("l2", "ip", "cosine"):
        dots = torch.einsum("bmd,mkd->bmk", qs, cb)
        if metric == "l2":
            qn = (qs * qs).sum(-1, keepdim=True)  # (B, M, 1)
            cn = (cb * cb).sum(-1)[None]  # (1, M, K)
            return (qn + cn - 2.0 * dots).clamp_min(0.0)
        return -dots if metric == "ip" else dots
    diff_q, diff_c = qs[:, :, None, :], cb[None]
    if metric == "l1":
        return (diff_q - diff_c).abs().sum(-1)
    if metric == "chi2":
        num = (diff_c - diff_q) ** 2
        den = diff_c + diff_q
        return torch.where(den > 1e-12, num / den.clamp_min(1e-12), 0.0).sum(-1)
    raise KeyError(f"unknown metric {metric!r}")


def adc_gather(
    lut: torch.Tensor,
    codes: torch.Tensor,
    idx: torch.Tensor,
    metric: str,
    sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, M, K) tables, (n, M) codes, (B, C) ids -> (B, C) float32 ADC
    distances, +inf at idx < 0.  Cosine needs the exact ``‖x‖²`` cache."""
    B, M, K = lut.shape
    C = idx.shape[1]
    safe = idx.long().clamp(0, codes.shape[0] - 1)
    flat = torch.arange(M, device=lut.device) * K + codes[safe].long()  # (B, C, M)
    d = torch.gather(lut.reshape(B, M * K), 1, flat.reshape(B, C * M)).reshape(B, C, M).sum(-1)
    if metric == "cosine":
        if sq_norms is None:
            raise ValueError("cosine ADC requires the sq_norms cache")
        d = 1.0 - d / sq_norms.float()[safe].sqrt().clamp_min(1e-12)
    return torch.where(idx >= 0, d, float("inf"))


def bytes_per_dim(precision: str) -> float:
    """Candidate-fetch bytes per dimension; PQ reads one code byte per
    subspace of _PQ_DSUB dims."""
    return {"fp32": 4.0, "bf16": 2.0, "int8": 1.0, "pq": 1.0 / _PQ_DSUB}[
        validate_precision(precision)
    ]
