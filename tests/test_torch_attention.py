"""The port's LM attention (``repro_torch.models.attention`` and the ring
decode) against ``repro.models.attention`` / ``repro.models.transformer`` on
the same numpy inputs.

* ``rope`` in fp32 and bf16.
* Chunked and tiled causal attention (the reference's jitted functions), at
  windows ``FULL_WINDOW`` and 8 and GQA groups 1, 2 and 4, on a length that
  is not a multiple of the chunk: fp32 inputs within rtol 1e-5 / atol 1e-6;
  bf16 inputs within one bf16 rounding of the output (2^-7 of its largest
  element: both sides compute the same fp32 sums in another order, then
  round to bf16).
* ``decode_attention`` and ``ring_decode_attention`` against the
  reference's on the same caches, before and after the ring wraps.
* The port's chunked schedule (q chunks batched per tile offset, fully
  masked tiles skipped) equals its tiled one to the last bit's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
B, S, H, DH, CHUNK = 2, 40, 4, 8, 16
WINDOWS = (ttfm.FULL_WINDOW, 8)
GROUPS = (1, 2, 4)

jchunked = jax.jit(jattn.chunked_causal_attention, static_argnames=("q_chunk", "kv_chunk"))
jtiled = jax.jit(jattn.tiled_causal_attention, static_argnums=(3,),
                 static_argnames=("q_chunk", "kv_chunk"))
jdecode = jax.jit(jattn.decode_attention, static_argnums=(4,))
jring = jax.jit(jtfm.ring_decode_attention, static_argnums=(4,))


def qkv(groups, seed=0, s=S):
    rs = np.random.RandomState(seed)
    kv = H // groups
    return (rs.randn(B, s, H, DH).astype(np.float32), rs.randn(B, s, kv, DH).astype(np.float32),
            rs.randn(B, s, kv, DH).astype(np.float32))


def to_bf16(*xs):
    """(jax bf16 arrays, torch bf16 tensors) of the same values."""
    js = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    ts = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    return js, ts


def bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    tol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_constants():
    assert tattn.NEG_INF == jattn.NEG_INF and ttfm.FULL_WINDOW == jtfm.FULL_WINDOW


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    x, _, _ = qkv(1, seed=1)
    pos = np.stack([np.arange(S), np.arange(S) + 1000]).astype(np.int32)
    want = jattn.rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6)
    got = tattn.rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), 1e6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    else:
        bf16_close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("groups", GROUPS)
def test_chunked_and_tiled_fp32(window, groups):
    q, k, v = qkv(groups)
    want_c = jchunked(q, k, v, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    want_t = jtiled(q, k, v, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got_c = tattn.chunked_causal_attention(tq, tk, tv, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    got_t = tattn.tiled_causal_attention(tq, tk, tv, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_c.numpy(), got_t.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("groups", GROUPS)
def test_chunked_and_tiled_bf16(window, groups):
    (jq, jk, jv), (tq, tk, tv) = to_bf16(*qkv(groups, seed=2))
    want = jchunked(jq, jk, jv, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    got = tattn.chunked_causal_attention(tq, tk, tv, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    bf16_close(got, want)
    got_t = tattn.tiled_causal_attention(tq, tk, tv, window, q_chunk=CHUNK, kv_chunk=CHUNK)
    bf16_close(got_t, want)


def test_unequal_chunks_and_a_short_sequence():
    """q_chunk != kv_chunk, and a sequence shorter than both chunks."""
    q, k, v = qkv(2, seed=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for s, qc, kc, w in ((S, 8, 16, 8), (S, 16, 8, ttfm.FULL_WINDOW), (6, 16, 16, 4)):
        want = jchunked(q[:, :s], k[:, :s], v[:, :s], w, q_chunk=qc, kv_chunk=kc)
        got = tattn.chunked_causal_attention(tq[:, :s], tk[:, :s], tv[:, :s], w, q_chunk=qc,
                                             kv_chunk=kc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def caches(groups, smax, seed):
    rs = np.random.RandomState(seed)
    kv = H // groups
    q = rs.randn(B, 1, H, DH).astype(np.float32)
    kc = rs.randn(B, smax, kv, DH).astype(np.float32)
    vc = rs.randn(B, smax, kv, DH).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("groups", GROUPS)
def test_decode_attention(window, groups):
    q, kc, vc = caches(groups, 24, seed=5)
    ln = np.array([3, 17], np.int32)
    want = jdecode(q, kc, vc, ln, window)
    got = tattn.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, ln)), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (jq, jk, jv), (tq, tk, tv) = to_bf16(q, kc, vc)
    bf16_close(tattn.decode_attention(tq, tk, tv, torch.from_numpy(ln), window),
               jdecode(jq, jk, jv, ln, window))


@pytest.mark.parametrize("window", (8, 5))
@pytest.mark.parametrize("groups", GROUPS)
def test_ring_decode_attention(window, groups):
    """Ring of 8 slots; lengths before the wrap, at it and past it."""
    q, kr, vr = caches(groups, 8, seed=6)
    for ln in ([0, 5], [8, 13], [30, 7]):
        ln = np.array(ln, np.int32)
        want = jring(q, kr, vr, ln, window)
        got = ttfm.ring_decode_attention(*(torch.from_numpy(a) for a in (q, kr, vr, ln)), window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (jq, jk, jv), (tq, tk, tv) = to_bf16(q, kr, vr)
    bf16_close(ttfm.ring_decode_attention(tq, tk, tv, torch.from_numpy(ln), window),
               jring(jq, jk, jv, ln, window))
