"""Attention for the LM family: GQA + RoPE + windowed causal masking
(counterpart of ``repro.models.attention``).

One parameterization covers full causal attention (stablelm, qwen, arctic),
sliding-window attention (mixtral, window 4096), gemma3's 5:1 local:global
alternation (the window is a per-layer integer) and KV-cache decode.

Prefill and training use the reference's two-level online softmax over
``q_chunk x kv_chunk`` tiles with a running (max, sum): the (S, S) score
matrix never exists.  The port keeps its arithmetic: scores and the PV
product are bf16 (or fp32) products accumulated and returned in fp32
(``preferred_element_type=float32``), the probabilities are rounded to V's
dtype before the PV product, the mask is ``(delta >= 0) & (delta < window)
& (kpos < s)`` with ``NEG_INF`` fill, and the sum is floored at 1e-30.

Grouped-query attention is computed on a ``(B, KV, groups, ...)`` view of
the queries against the KV heads themselves (query head ``kv * groups + j``
reads KV head ``kv``, the reference's layout): the reference's
``_repeat_kv`` copy of K and V (``groups`` times, 8.6 GB per global layer
of gemma3 at decode_32k) is never made, and the sums are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib

NEG_INF = -1e30


def acc_dtype(*xs: torch.Tensor) -> torch.dtype:
    """The dtype the reference accumulates a product of ``xs`` in: fp32 for
    bf16 and fp32 operands; float64 operands (a host-side check of the
    card's numbers) stay float64."""
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the products accumulated in, and returned as, fp32
    (``einsum(..., preferred_element_type=float32)``).  A bf16 x bf16
    product is exact in fp32, so widening both operands first computes the
    reference's function; the CPU does that.  On the card, bf16 operands
    outside autograd go to cuBLAS's bf16 GEMM with fp32 output
    (``torch.bmm(..., out_dtype=float32)``): the same function (fp32
    accumulation, one fp32 rounding of each sum) without writing fp32
    copies of the operands, which at decode_32k would be 4.3 GB per cache
    tensor per layer.  That call has no derivative, so a product that takes
    part in a gradient widens its operands on the card too."""
    dt = acc_dtype(a, b)
    if (device_lib.on_card(a) and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
        return out.reshape(*batch, a.shape[-2], b.shape[-1])
    return torch.matmul(a.to(dt), b.to(dt))


def rope_tables(positions: torch.Tensor, dh: int, theta: float) -> tuple:
    """(cos, sin), each (B, S, 1, dh/2) fp32, of ``rope``'s angles: they
    depend on the positions alone, so one call serves every layer and both
    q and k."""
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """``rope`` with its (cos, sin) from ``rope_tables``."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, Dh), positions: (B, S).  Angles in
    fp32; the result is cast back to x's dtype."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


class _Tiles:
    """Padded, tiled operands of a causal attention.

    ``q``: (B, KV, nq, G*qc, Dh), the queries of KV head ``kv``'s groups
    stacked along rows (scaled, in q's dtype); ``kt``: (B, KV, nk, Dh, kc);
    ``v``: (B, KV, nk, kc, Dh)."""

    def __init__(self, q, k, v, q_chunk, kv_chunk, softmax_scale):
        b, s, h, dh = q.shape
        kvh = k.shape[2]
        g = h // kvh
        scale = softmax_scale if softmax_scale is not None else dh ** -0.5
        qc, kc = min(q_chunk, s), min(kv_chunk, s)
        nq, nk = -(-s // qc), -(-s // kc)
        self.shape = (b, s, h, dh, kvh, g, qc, kc, nq, nk)
        qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * qc - s))
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * kc - s))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * kc - s))
        qb = (qp * scale).reshape(b, nq, qc, kvh, g, dh).permute(0, 3, 1, 4, 2, 5)
        self.q = qb.reshape(b, kvh, nq, g * qc, dh)
        self.kt = kp.reshape(b, nk, kc, kvh, dh).permute(0, 3, 1, 4, 2)
        self.v = vp.reshape(b, nk, kc, kvh, dh).permute(0, 3, 1, 2, 4)
        self.v_dtype = v.dtype
        self.dev = q.device

    def needed(self, qi: int, ki: int, window: int) -> bool:
        """Tile (qi, ki) holds an unmasked pair.  A fully masked tile leaves
        the running (max, sum, acc) as it was once a row has seen a key, and
        every row sees its own key by its diagonal tile; before that, what
        a masked tile adds is scaled by exp(NEG_INF - max) = 0 when the
        first key arrives.  So skipping it changes no value."""
        *_, qc, kc, _, _ = self.shape
        q_lo, q_hi = qi * qc, (qi + 1) * qc - 1
        k_lo, k_hi = ki * kc, (ki + 1) * kc - 1
        return not (k_lo > q_hi or k_hi < q_lo - window + 1)

    def mask(self, qis: range, kis: range, window: int) -> torch.Tensor:
        """(n, G*qc, kc) bool mask of the tile pairs (qis[i], kis[i])."""
        s, g, qc, kc = self.shape[1], self.shape[5], self.shape[6], self.shape[7]
        qpos = (torch.arange(qis.start, qis.stop, device=self.dev)[:, None] * qc
                + torch.arange(qc, device=self.dev))
        kpos = (torch.arange(kis.start, kis.stop, device=self.dev)[:, None] * kc
                + torch.arange(kc, device=self.dev))
        delta = qpos[:, :, None] - kpos[:, None, :]
        m = (delta >= 0) & (delta < window) & (kpos < s)[:, None, :]
        n = len(qis)
        return m[:, None].expand(n, g, qc, kc).reshape(n, g * qc, kc)

    def update(self, state, qt, kt, vt, mask):
        """One online-softmax step of query tiles against key tiles."""
        m, l, acc = state
        scores = matmul_f32(qt, kt)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + matmul_f32(p.to(self.v_dtype), vt)
        return m_new, l_new, acc_new

    def init_state(self, n: int, dt: torch.dtype):
        b, _, _, dh, kvh, g, qc = self.shape[:7]
        m0 = torch.full((b, kvh, n, g * qc), NEG_INF, dtype=dt, device=self.dev)
        return m0, torch.zeros_like(m0), torch.zeros((b, kvh, n, g * qc, dh), dtype=dt,
                                                       device=self.dev)

    def output(self, l, acc, dtype) -> torch.Tensor:
        """(B, KV, nq, G*qc, Dh) accumulators -> (B, S, H, Dh) in ``dtype``."""
        b, s, h, dh, kvh, g, qc, _, nq, _ = self.shape
        out = acc / torch.clamp(l[..., None], min=1e-30)
        out = out.reshape(b, kvh, nq, g, qc, dh).permute(0, 2, 4, 1, 3, 5)
        return out.reshape(b, nq * qc, h, dh)[:, :s].to(dtype)


def chunked_causal_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, KV, Dh)
    v: torch.Tensor,  # (B, S, KV, Dh)
    window: int,  # attend to j with 0 <= i - j < window
    *,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style attention: running (max, sum) over kv tiles.

    The reference maps over q chunks one at a time (to bound memory) and
    scans every kv tile for each.  Here all q chunks that need a kv tile at
    one offset ``qi - ki`` are updated together, offsets from the farthest
    to the diagonal, so each q chunk still meets its kv tiles in ascending
    order; fully masked tiles are skipped (``_Tiles.needed``: no value
    changes).  Memory high-water: (B, H, S, kv_chunk) fp32 scores.
    """
    t = _Tiles(q, k, v, q_chunk, kv_chunk, softmax_scale)
    nq, nk = t.shape[8], t.shape[9]
    dt = acc_dtype(q, k)
    m, l, acc = t.init_state(nq, dt)
    # the offsets d = qi - ki with a needed tile, farthest first; for each,
    # the q chunks that need their tile at that offset form one range
    for d in range(nq - 1, -nk, -1):
        qis = [qi for qi in range(max(0, d), min(nq, nk + d)) if t.needed(qi, qi - d, window)]
        if not qis:
            continue
        a, b = qis[0], qis[-1] + 1
        sl = slice(a, b)
        ks = slice(a - d, b - d)
        mask = t.mask(range(a, b), range(a - d, b - d), window)
        new = t.update((m[:, :, sl], l[:, :, sl], acc[:, :, sl]), t.q[:, :, sl], t.kt[:, :, ks],
                       t.v[:, :, ks], mask)
        m, l, acc = (torch.cat([old[:, :, :a], n_, old[:, :, b:]], dim=2)
                     for old, n_ in zip((m, l, acc), new))
    return t.output(l, acc, q.dtype)


def tiled_causal_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, KV, Dh)
    v: torch.Tensor,  # (B, S, KV, Dh)
    window: int,  # static window (0 < w; FULL_WINDOW for none)
    *,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The reference's statically tiled schedule: a loop over q chunks, each
    over its kv tiles in ascending order, fully masked tiles never computed.
    Functionally identical to ``chunked_causal_attention``; used when
    ``TransformerConfig.unrolled``."""
    t = _Tiles(q, k, v, q_chunk, kv_chunk, softmax_scale)
    nq, nk = t.shape[8], t.shape[9]
    dt = acc_dtype(q, k)
    ls, accs = [], []
    for qi in range(nq):
        state = tuple(x[:, :, 0] for x in t.init_state(1, dt))
        for ki in range(nk):
            if not t.needed(qi, ki, window):
                continue
            mask = t.mask(range(qi, qi + 1), range(ki, ki + 1), window)[0]
            state = t.update(state, t.q[:, :, qi], t.kt[:, :, ki], t.v[:, :, ki], mask)
        ls.append(state[1])
        accs.append(state[2])
    return t.output(torch.stack(ls, dim=2), torch.stack(accs, dim=2), q.dtype)


def _decode_scores(q: torch.Tensor, k: torch.Tensor, softmax_scale) -> torch.Tensor:
    """(B, 1, H, Dh) query against (B, S, KV, Dh) keys -> (B, KV, G, S) fp32
    scores, the query scaled in its own dtype first."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qs = (q * scale).reshape(b, kvh, h // kvh, dh)
    return matmul_f32(qs, k.permute(0, 2, 3, 1))


def _decode_out(scores: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the (B, KV, G, S) scores, probabilities rounded to
    V's dtype, PV in fp32 -> (B, 1, H, Dh) in q's dtype."""
    b, _, h, dh = q.shape
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = matmul_f32(p, v.permute(0, 2, 1, 3))  # (B, KV, G, Dh)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh) — the new token's query
    k_cache: torch.Tensor,  # (B, S, KV, Dh)
    v_cache: torch.Tensor,  # (B, S, KV, Dh)
    cache_len: torch.Tensor,  # (B,) valid prefix length (new token goes at cache_len)
    window: int,
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """One-step decode: the new query against the whole KV cache."""
    s = k_cache.shape[1]
    scores = _decode_scores(q, k_cache, softmax_scale)
    pos = torch.arange(s, device=q.device)[None, :]
    delta = cache_len[:, None] - pos
    mask = (delta >= 0) & (delta < window)
    return _decode_out(scores, mask, v_cache, q)


def ring_decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_ring: torch.Tensor,  # (B, W, KV, Dh) — ring buffer, slot p % W holds position p
    v_ring: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) — the new token's position
    window: int,
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a ring-buffered window cache (exact SWA)."""
    W = k_ring.shape[1]
    scores = _decode_scores(q, k_ring, softmax_scale)
    # slot i holds position p = len - ((len - i) mod W); p < 0 = never written
    slot = torch.arange(W, device=q.device)[None, :]
    ln = cache_len[:, None]
    p = ln - torch.remainder(ln - slot, W)
    delta = ln - p
    mask = (delta >= 0) & (delta < window) & (p >= 0)
    return _decode_out(scores, mask, v_ring, q)
