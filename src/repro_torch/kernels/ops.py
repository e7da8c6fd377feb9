"""The one routing point between the CUDA kernels and their plain versions
(counterpart of ``repro.kernels.ops``).

The tensor's device decides, and nothing else: a tensor on the CPU takes the
plain PyTorch version; a tensor on a CUDA device takes the hand-written
kernel, which launches or raises.  There is no engine option and no
fallback.  The kernels are reached through their registered operators
(``repro_torch::pairwise_distance``, ``::gather_distance``,
``::fused_expand``, ``::tile_topk``), whose fake forms let the dry run trace
them; the dry run sends its fake CPU tensors the card's way
(``device.card_program``).
Callers in ``repro_torch.core`` reach the kernels only through these
functions, by module attribute (``ops.expand_step(...)``).  The PQ
rank-then-rerank composes here, around the exact fp32 expansion.

A metric registered with ``core.metrics.register`` has no kernel: on a CUDA
tensor these functions refuse it before any launch
(``require_kernel_metric``), as the reference's Pallas kernels refuse it.

Launch counts: ``launch_counts()`` reads, and ``reset_launch_counts()``
zeroes, the per-kernel integers the wrappers bump where they launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import on_card
from repro_torch.kernels import _cuda, ref
from repro_torch.kernels import distance as _distance
from repro_torch.kernels import expand as _expand
from repro_torch.kernels import gather_dist as _gather_dist
from repro_torch.kernels import precision as precision_lib
from repro_torch.kernels import tile_topk as _tile_topk


def launch_counts() -> dict:
    return dict(_cuda.LAUNCHES)


def reset_launch_counts() -> None:
    _cuda.reset_launches()


def require_kernel_metric(metric: str, kernel_metrics) -> None:
    """Raise ``KeyError`` naming ``metric`` and the metrics the kernels
    compute (``kernel_metrics``, a kernel module's ``KERNEL_METRIC``) when
    no kernel computes it."""
    if metric not in kernel_metrics:
        raise KeyError(
            f"metric {metric!r} has no CUDA kernel; the kernels compute "
            f"{sorted(kernel_metrics)}. A registered metric runs through the plain "
            "versions on CPU tensors only"
        )


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    *,
    x_sq_norms: Optional[torch.Tensor] = None,
    enc: Optional[precision_lib.EncodedData] = None,
    precision: str = "fp32",
) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) float32 distances.

    fp32 and bf16 operands run the kernel (a bf16 pair its bf16-operand
    instantiation, fp32 accumulation).  A compressed x side
    (``enc``/``precision`` bf16, int8 or pq) is plain PyTorch on either
    device, as in the reference, whose Pallas pairwise kernel never takes
    one: it feeds no kernel of the main path."""
    compressed = enc is not None and precision != "fp32"
    card = on_card(x)
    if card:
        require_kernel_metric(metric, _distance.KERNEL_METRIC)
    if card and not compressed:
        return _distance.pairwise_distance(q, x, metric, x_sq_norms=x_sq_norms)
    return ref.pairwise_distance(q, x, metric, x_sq_norms=x_sq_norms, enc=enc, precision=precision)


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
    """(b, d) queries vs rows x[idx] -> (b, c) float32; +inf at idx < 0.

    ``enc``/``precision`` select the candidate table: bf16 and int8 run that
    variant of the kernel (or its plain version on the CPU); ``"pq"`` is the
    plain ADC rank on either device, as in the reference (ADC has no TPU
    kernel to port)."""
    card = on_card(x)
    if card:
        require_kernel_metric(metric, _gather_dist.KERNEL_METRIC)
    if enc is None or precision == "fp32":
        enc, precision = None, "fp32"
    if precision == "pq" or not card:
        return ref.gather_distance(
            q, x, idx, metric, sq_norms=sq_norms, enc=enc, precision=precision
        )
    table, row_scale = kernel_table(x, enc)
    return _gather_dist.gather_distance(
        q, table, idx, metric, sq_norms=sq_norms, row_scale=row_scale
    )


# query rows per ``merge_proposals`` gather: the plain version holds a
# chunk's (rows, C, d) candidate rows at once (16,384 x 400 x 128 floats is
# 3.4 GB), and rows are independent, so the chunking changes no value
MERGE_PROPOSAL_ROWS = 16384


def merge_proposals(
    q: torch.Tensor,
    xt: torch.Tensor,
    hit_ids: torch.Tensor,
    t_nbr_ids: torch.Tensor,
    t_alive: torch.Tensor,
    metric: str = "l2",
    *,
    sq_norms: Optional[torch.Tensor] = None,
    hop_top: Optional[int] = None,
):
    """Second-hop merge candidates: for each query row with cross-search
    hits ``hit_ids`` (B, k) (target-local ids, -1 padded, nearest first),
    the forward lists of its nearest ``hop_top`` hits in the target graph
    (``t_nbr_ids``), dead targets masked, with their distances from
    ``gather_distance`` (``sq_norms``: the target's norm cache), in chunks
    of ``MERGE_PROPOSAL_ROWS`` query rows.

    Returns (ids (B, h·k_t) int32 target-local, -1 masked; distances, +inf
    at masked lanes; the number of lanes evaluated, a 0-d int64 tensor),
    h = min(hop_top, k)."""
    if hop_top is not None and hop_top < hit_ids.shape[1]:
        hit_ids = hit_ids[:, :hop_top]
    ids, dists = [], []
    comps = torch.zeros((), dtype=torch.int64, device=hit_ids.device)
    chunk = MERGE_PROPOSAL_ROWS
    for lo in range(0, hit_ids.shape[0], chunk):
        hit = hit_ids[lo:lo + chunk]
        hop = t_nbr_ids[hit.clamp_min(0).long()]  # (b, h, k_t)
        hop = torch.where(hit[:, :, None] >= 0, hop, -1).reshape(hit.shape[0], -1)
        hop = torch.where((hop >= 0) & t_alive[hop.clamp_min(0).long()], hop, -1)
        d = gather_distance(q[lo:lo + chunk], xt, hop, metric, sq_norms=sq_norms)
        live = hop >= 0
        ids.append(hop)
        dists.append(torch.where(live, d, float("inf")))
        comps = comps + live.sum()
    width = hit_ids.shape[1] * t_nbr_ids.shape[1]
    if not ids:
        return (torch.empty((0, width), dtype=torch.int32, device=hit_ids.device),
                torch.empty((0, width), dtype=torch.float32, device=hit_ids.device), comps)
    return torch.cat(ids), torch.cat(dists), comps


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
    """Fold a tile of distances (m, T), ids ``lo ..``, into the running best
    (m, k): the new (best_d, best_i); see ``ref.tile_topk``.  The kernel
    equals the plain version bit for bit."""
    if on_card(dt):
        return _tile_topk.tile_topk(dt, best_d, best_i, lo, n_valid, alive=alive,
                                    exclude_ids=exclude_ids)
    return ref.tile_topk(dt, best_d, best_i, lo, n_valid, alive=alive, exclude_ids=exclude_ids)


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise smallest-k (dists, ids), ties to the lower column; see
    ``ref.topk_smallest``."""
    return ref.topk_smallest(dists, ids, k)


def expand_step(
    q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
    *, metric: str = "l2", hash_probes: int = 8, sq_norms: Optional[torch.Tensor] = None,
    enc: Optional[precision_lib.EncodedData] = None, precision: str = "fp32",
    rerank_keep: int = 0,
):
    """One EHC expansion step; see ``kernels.expand``.  The visited hash is
    updated in place.

    bf16/int8 read the compressed table inside the expansion.  ``"pq"`` runs
    rank-then-rerank: the fresh candidates are ranked by ADC, the best
    ``rerank_keep`` go through the exact fp32 expansion, and every fresh
    candidate counts in ``comps``."""
    card = on_card(x)
    if card:
        require_kernel_metric(metric, _gather_dist.KERNEL_METRIC)
    if enc is None or precision == "fp32":
        enc, precision = None, "fp32"
    if precision == "pq":
        if rerank_keep <= 0:
            raise ValueError("pq expansion needs rerank_keep > 0")
        return _pq_rank_then_rerank(
            q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
            metric=metric, hash_probes=hash_probes, sq_norms=sq_norms, enc=enc,
            rerank_keep=rerank_keep,
        )
    if not card:
        return _expand.expand_reference(
            q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
            metric=metric, probes=hash_probes, sq_norms=sq_norms, enc=enc, precision=precision,
        )
    table, row_scale = kernel_table(x, enc)
    return _expand.fused_expand(
        q, table, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
        metric=metric, probes=hash_probes, sq_norms=sq_norms, row_scale=row_scale,
    )


def kernel_table(x, enc):
    """The kernels' candidate table and int8 scales: ``x``, or ``enc``'s."""
    return (x, None) if enc is None else (enc.data, enc.scale)


def _pq_rank_then_rerank(
    q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
    *, metric, hash_probes, sq_norms, enc, rerank_keep,
):
    """ADC first-pass rank, then the exact fp32 expansion of the survivors
    (the reference's ``ops._pq_rank_then_rerank``).

    The prerank never touches the hash: fresh candidates are classified as
    the expansion will classify them, ranked by ADC, and all but the
    ``rerank_keep`` smallest scores (ties to the lower column) are masked to
    -1.  Dropped candidates are recorded nowhere and may be found, and
    charged, again later."""
    keep = min(rerank_keep, cands.shape[1])
    present, _, _ = _expand.hash_probe_state(vis_ids, cands, hash_probes)
    fresh = (cands >= 0) & ~present
    adc = ref.gather_distance(
        q, x, torch.where(fresh, cands, -1), metric, sq_norms=sq_norms, enc=enc,
        precision="pq",
    )
    sel = torch.sort(ref.sort_key(adc), dim=1, stable=True).indices[:, :keep]
    survive = torch.zeros_like(fresh).scatter_(1, sel, True)
    bi, bd, be, vi, vd, _ = expand_step(
        q, x, torch.where(survive, cands, -1), beam_ids, beam_dist, beam_exp,
        vis_ids, vis_dist, metric=metric, hash_probes=hash_probes, sq_norms=sq_norms,
    )
    # every fresh candidate cost one (ADC) evaluation; the exact re-ranks
    # are a subset of them, not an addition
    return bi, bd, be, vi, vd, fresh.sum(dim=1).to(torch.int32)
