"""The yardstick's table of peaks and its counts of work, frozen here.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W; a card set to a lower ``power.limit`` reads lower shares): HBM3 at
3.35 TB/s, 67 TFLOP/s for fp32 products on the CUDA cores, 989 TFLOP/s for
bf16 x bf16 products on the tensor cores.

The counts are copies of the port's own arithmetic as it stood when the
benchmark was written (``launch/profile_build.bound_ms`` and
``expand_bytes``, ``launch/bench_gather.gather_bytes``, the cost function
beside ``kernels/distance.py``'s operator), kept here because later changes
may edit those files.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FLOP_PER_S = {"fp32": FP32_FLOP_PER_S, "bf16": 989e12}
ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def bound_ms(nbytes: float, flops: float, operands: str = "fp32") -> tuple[float, str]:
    """Least time on an H100: the larger of bytes over the HBM rate and
    flops over the rate for products of ``operands``, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[operands] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expand_bytes(B, C, e, d, P, precision, fresh, valid, inserted) -> float:
    """Bytes one ``fused_expand`` launch must move: queries, candidate ids,
    the fresh rows at the table's width (int8 with its scale) and their
    norms, ``P`` probed hash ids per valid candidate, the recorded
    (id, dist) pairs, the beam in and out (id, dist, flag) and comps."""
    row_bytes = ELEM_BYTES[precision] * d + (4 if precision == "int8" else 0)
    return (4 * (B * d + B * C + fresh) + fresh * row_bytes + 4 * valid * P + 8 * inserted
            + 2 * B * e * 9 + 4 * B)


def gather_bytes(B: int, C: int, d: int, rows: int, precision: str) -> int:
    """Bytes one gather must move: queries, ids, each of the ``rows``
    distinct rows once at the table's width with its norm, the outputs."""
    row_bytes = ELEM_BYTES[precision] * d + (4 if precision == "int8" else 0)
    return 4 * (B * d + B * C + rows + B * C) + rows * row_bytes


def pairwise_cost(m: int, n: int, d: int, *, elem_bytes: int = 4, cached_norms: bool = False):
    """(flops, bytes) of one (m, d) x (n, d) pairwise tile on fp32 operands:
    2·m·n·d products and sums; both operands, the norm cache when given and
    the (m, n) float32 result each move once."""
    nbytes = (m + n) * d * elem_bytes + (4 * n if cached_norms else 0) + 4 * m * n
    return 2.0 * m * n * d, nbytes


def exact_search_cost(m: int, n: int, d: int, k: int):
    """(flops, bytes) of an exact k-NN search of m queries over n rows,
    whatever implements it: 2·m·n·d for the distances; each row and query
    read once, the (m, k) ids and distances written once."""
    return 2.0 * m * n * d, 4 * (n + m) * d + 8 * m * k
