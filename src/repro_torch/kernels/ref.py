"""Plain PyTorch versions of the kernels (counterpart of
``repro.kernels.ref``, with ``tile_topk``, the running top-k of an exact
tile, which the reference leaves to ``lax.top_k``).

These are the CPU execution path and the oracle each CUDA kernel is held
against on the card.  The gather distance uses the same norms-decomposed
formula as the kernels (``‖q‖² + ‖x‖² − 2·q·x`` with ``‖x‖²`` from the
graph-resident cache), so the kernel and its plain version agree bit for bit
on integer-valued data and to float tolerance elsewhere.  With
``enc``/``precision`` (``kernels.precision``) the same body reads bf16 or
int8 rows, or ranks by PQ-ADC.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import metrics
from repro_torch.core.graph import squared_norms
from repro_torch.kernels import precision as precision_lib


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    *,
    x_sq_norms: Optional[torch.Tensor] = None,
    enc: Optional[precision_lib.EncodedData] = None,
    precision: str = "fp32",
) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) float32; the l2 form consumes the cached
    ``‖x‖²`` when given.  Operands of any float dtype are widened to fp32.
    ``enc``/``precision`` take the x side from a compressed table
    (``pairwise_distance_compressed``)."""
    if enc is not None and precision != "fp32":
        return pairwise_distance_compressed(q, x, metric, x_sq_norms=x_sq_norms, enc=enc,
                                            precision=precision)
    if x_sq_norms is not None and metric == "l2":
        qf, xf = q.float(), x.float()
        qn = (qf * qf).sum(-1, keepdim=True)
        return (qn + x_sq_norms.float()[None, :] - 2.0 * (qf @ xf.T)).clamp_min(0.0)
    return metrics.pairwise(metric, q, x)


def pairwise_distance_compressed(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str,
    *,
    x_sq_norms: Optional[torch.Tensor],
    enc: precision_lib.EncodedData,
    precision: str,
) -> torch.Tensor:
    """All-pairs distances against a compressed x side: the bf16 or int8
    table, or PQ-ADC codes (the reference's ``ref._pairwise_distance_compressed``,
    which runs outside any Pallas kernel: plain PyTorch on either device).

    The ``‖x‖²`` term comes from the exact cache (derived from ``x`` when
    absent); l2/ip/cosine take the dot with the widened table, int8 scaling
    it by the row's scale (1 at zero scales); l1/chi2 dequantize the table
    and reduce exactly; pq sums the per-subspace ADC tables over each row's
    codes, cosine dividing the dot by the exact norm."""
    precision_lib.validate_precision(precision)
    qf = q.float()
    if x_sq_norms is None:
        x_sq_norms = squared_norms(x)
    xn = x_sq_norms.float()[None, :]  # (1, n)
    if metric == "cosine":
        qf = metrics.normalize_rows(qf)
    if precision == "pq":
        lut = precision_lib.adc_tables(qf, enc.codebook, metric)  # (m, M, K)
        M = lut.shape[1]
        codes = enc.codes.long()  # (n, M)
        d = torch.zeros((qf.shape[0], codes.shape[0]), dtype=torch.float32, device=qf.device)
        for j in range(M):  # subspace order, as the reference sums its terms
            d = d + lut[:, j, :][:, codes[:, j]]
        if metric == "cosine":
            d = 1.0 - d / xn.sqrt().clamp_min(1e-12)
        return d
    table = enc.data.float()
    scale = None
    if precision == "int8":
        s = enc.scale.float()
        scale = torch.where(s > 0, s, 1.0)
    if metric in ("l2", "ip", "cosine"):
        dots = qf @ table.T
        if scale is not None:
            dots = dots * scale[None, :]
        if metric == "l2":
            qn = (qf * qf).sum(-1, keepdim=True)
            return (qn + xn - 2.0 * dots).clamp_min(0.0)
        if metric == "cosine":
            return 1.0 - dots / xn.sqrt().clamp_min(1e-12)
        return -dots
    if scale is not None:
        table = table * scale[:, None]
    return metrics.pairwise(metric, q, table)


def gather_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    metric: str = "l2",
    *,
    sq_norms: Optional[torch.Tensor] = None,
    enc: Optional[precision_lib.EncodedData] = None,
    precision: str = "fp32",
) -> torch.Tensor:
    """(b, d) queries vs rows x[idx] (b, c) -> (b, c) float32; +inf at idx < 0.

    ``sq_norms`` is the (n,) graph-resident ``‖x‖²`` cache; the gathered rows'
    norms are derived when it is absent.  ``enc``/``precision`` select a
    compressed candidate table; fp32 (or no ``enc``) reads ``x``.  A
    compressed table takes its ``‖x‖²`` term from the exact norms of ``x``;
    int8 scales the dot for l2/ip/cosine and each element for l1/chi2 (1 at
    zero scales); pq ranks by ADC.
    """
    precision_lib.validate_precision(precision)
    compressed = enc is not None and precision != "fp32"
    if compressed and sq_norms is None:
        sq_norms = squared_norms(x)
    qf = metrics.normalize_rows(q) if metric == "cosine" else q.float()
    if compressed and precision == "pq":
        lut = precision_lib.adc_tables(qf, enc.codebook, metric)
        return precision_lib.adc_gather(lut, enc.codes, idx, metric, sq_norms)
    safe = idx.long().clamp(0, x.shape[0] - 1)
    cand = (enc.data if compressed else x)[safe].float()  # (b, c, d)
    scale = None
    if compressed and precision == "int8":
        s = enc.scale.float()[safe]
        scale = torch.where(s > 0, s, 1.0)
    if metric in ("l2", "ip", "cosine"):
        dots = (qf[:, None, :] * cand).sum(-1)
        if scale is not None:
            dots = dots * scale
        if metric == "ip":
            d = -dots
        else:
            xn = (cand * cand).sum(-1) if sq_norms is None else sq_norms.float()[safe]
            if metric == "l2":
                qn = (qf * qf).sum(-1, keepdim=True)
                d = (qn + xn - 2.0 * dots).clamp_min(0.0)
            else:
                d = 1.0 - dots / xn.sqrt().clamp_min(1e-12)
    else:
        if scale is not None:
            cand = cand * scale[..., None]
        d = metrics.row_terms(metric, q, cand)
    return torch.where(idx >= 0, d, float("inf"))


def sort_key(dists: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in IEEE total order (-0.0 before +0.0).

    ``jax.lax.top_k`` ranks in total order with ties to the lower index, so a
    stable ascending sort on these keys reproduces its selection exactly."""
    bits = dists.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


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
    """One tile of ``core.brute``'s running top-k: the tile's distances
    ``dt`` (m, T) (ids ``lo .. lo + T - 1``) masked to +inf at ids ≥
    ``n_valid``, where the tile's ``alive`` slice (zero-padded to T) is
    False and at each row's ``exclude_ids``, then the k smallest of the
    running best (``best_d``/``best_i``, (m, k)) followed by the tile
    (``topk_smallest``).  The plain version of ``kernels.tile_topk``."""
    m, tile = dt.shape
    k = best_d.shape[1]
    ids = lo + torch.arange(tile, dtype=torch.int32, device=dt.device)[None, :]
    mask = ids < n_valid
    if alive is not None:
        short = tile - alive.shape[0]
        if short:
            alive = torch.cat([alive, alive.new_zeros(short)])
        mask = mask & alive[None, :]
    if exclude_ids is not None:
        mask = mask & (ids != exclude_ids[:, None])
    dt = torch.where(mask, dt, float("inf"))
    cat_d = torch.cat([best_d, dt], dim=1)
    cat_i = torch.cat([best_i, ids.expand(m, tile)], dim=1)
    return topk_smallest(cat_d, cat_i, k)


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise smallest-k: ((m, k) dists ascending, (m, k) ids), ties to the
    lower column.  A stable sort, never ``torch.topk`` (whose tie order is
    unspecified)."""
    order = torch.sort(sort_key(dists), dim=1, stable=True).indices[:, :k]
    return torch.gather(dists, 1, order), torch.gather(ids, 1, order)
