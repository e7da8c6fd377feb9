"""Plain exact k-NN and distances: the reference every cell is judged by.

Plain PyTorch on whatever device the tensors are on; it imports nothing of
the program and reads only the benchmark's own rows and queries, and the
program's outputs that it judges.  Candidates are ranked in float32 (TF32
off) and re-ranked in float64 on a margin of extra candidates, so the
result is the float64 top-k unless more than ``margin`` rows tie with the
k-th within float32 rounding.
"""

from __future__ import annotations

import contextlib

import torch

# rows of a float64 gather held at once: (chunk, k, d) at 8 bytes
_GATHER_ELEMS = 1 << 26


@contextlib.contextmanager
def ieee_fp32():
    """float32 products in IEEE float32 (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _d64(q64: torch.Tensor, rows64: torch.Tensor, metric: str) -> torch.Tensor:
    """float64 distances of q (m, d) to rows (m, c, d) -> (m, c)."""
    if metric == "l2":
        return ((q64[:, None, :] - rows64) ** 2).sum(-1)
    if metric == "cosine":
        qn = q64 / q64.norm(dim=-1, keepdim=True).clamp_min(1e-300)
        dots = (qn[:, None, :] * rows64).sum(-1)
        return 1.0 - dots / rows64.norm(dim=-1).clamp_min(1e-300)
    raise KeyError(f"the reference has no metric {metric!r}")


def distances(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, metric: str):
    """float64 distances of each q[i] to x[ids[i, j]] (NaN where the id is
    out of range) and each entry's scale: ``‖q‖² + ‖x‖²`` under l2, whose
    float32 evaluation rounds on that scale, and 1 under cosine.  Both
    (m, c) float64 on x's device."""
    dev = x.device
    ids = ids.to(dev).long()
    q = q.to(dev)
    m, c = ids.shape
    n = x.shape[0]
    out = torch.empty((m, c), dtype=torch.float64, device=dev)
    scale = torch.ones((m, c), dtype=torch.float64, device=dev)
    step = max(1, _GATHER_ELEMS // max(1, c * x.shape[1]))
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        i = ids[lo:hi]
        ok = (i >= 0) & (i < n)
        rows = x[i.clamp(0, n - 1)].double()
        q64 = q[lo:hi].double()
        out[lo:hi] = torch.where(ok, _d64(q64, rows, metric), float("nan"))
        if metric == "l2":
            scale[lo:hi] = (q64 * q64).sum(-1, keepdim=True) + (rows * rows).sum(-1)
    return out, scale


def knn(x: torch.Tensor, q: torch.Tensor, k: int, metric: str, *, self_ids=None,
        margin: int = 32, q_chunk: int = 1024):
    """Exact top-k of each query among the rows of x: (ids (m, k) int64,
    dists (m, k) float64), ascending, ties to the lower id.  ``self_ids``
    (m,) leaves each query's own row out."""
    dev = x.device
    q = q.to(dev).float()
    n = x.shape[0]
    kk = min(n, k + margin)
    with ieee_fp32():
        if metric == "l2":
            xs = x.float()
            xn = (xs * xs).sum(-1)
        else:
            xs = x.float() / x.float().norm(dim=-1, keepdim=True).clamp_min(1e-12)
        ids_out, d_out = [], []
        for lo in range(0, q.shape[0], q_chunk):
            qc = q[lo:lo + q_chunk]
            if metric == "l2":
                score = xn[None, :] - 2.0 * (qc @ xs.T)
            else:
                score = -(qc @ xs.T)
            if self_ids is not None:
                own = self_ids[lo:lo + q_chunk].to(dev).long()
                score[torch.arange(qc.shape[0], device=dev), own] = float("inf")
            cand = torch.topk(score, kk, dim=1, largest=False).indices
            del score
            d64, _ = distances(x, qc, cand, metric)
            # ascending by distance, ties to the lower id: sort by id, then
            # stably by distance
            by_id = torch.sort(cand, dim=1).indices
            cand, d64 = cand.gather(1, by_id), d64.gather(1, by_id)
            order = torch.sort(d64, dim=1, stable=True).indices[:, :k]
            ids_out.append(cand.gather(1, order))
            d_out.append(d64.gather(1, order))
    return torch.cat(ids_out), torch.cat(d_out)
