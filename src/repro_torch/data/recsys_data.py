"""Recommender batch generators (counterpart of ``repro.data.recsys_data``):
criteo-like CTR batches and behaviour sequences.

The CTR layout follows the Criteo convention the archs were published on:
13 dense features and 39 categorical fields with zipf-skewed ids over large
per-field vocabularies.  Labels come from a hidden sparse linear model over
the field ids, so CTR training has signal.

Every draw comes from the explicit ``torch.Generator`` on its device.  The
id transform keeps the reference's float32 ``vocab * u ** (a + 1)`` and its
truncation, so the ids follow the same distribution (the numbers differ from
the reference's ``jax.random`` streams).
"""

from __future__ import annotations

from typing import Dict

import torch


def _uniform(generator: torch.Generator, shape, low: float = 0.0) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return low + u * (1.0 - low) if low else u


def zipf_ids(generator: torch.Generator, shape, vocab: int, a: float = 1.2) -> torch.Tensor:
    """Zipf-ish categorical ids: id ~ rank^-a over [0, vocab), int32."""
    u = _uniform(generator, shape, 1e-6)
    ids = (vocab * u ** (a + 1.0)).to(torch.int32)
    return ids.clamp(max=vocab - 1)


def ctr_batch(
    generator: torch.Generator,
    batch: int,
    n_sparse: int,
    vocab: int,
    *,
    n_dense: int = 13,
) -> Dict[str, torch.Tensor]:
    """One CTR batch: dense (B, 13), sparse ids (B, F), label (B,)."""
    g, dev = generator, generator.device
    dense = torch.randn((batch, n_dense), generator=g, device=dev)
    sparse = zipf_ids(g, (batch, n_sparse), vocab)
    # hidden model: a few "hot" hash buckets drive the label
    w = torch.sin(torch.arange(n_sparse, dtype=torch.float32, device=dev) * 1.7)[None, :]
    score = torch.where(sparse % 97 < 8, w, -0.05 * w).sum(dim=1)
    score = score + 0.3 * dense[:, 0]
    label = torch.bernoulli(torch.sigmoid(score), generator=g)
    return {"dense": dense, "sparse": sparse, "label": label}


def behavior_batch(
    generator: torch.Generator,
    batch: int,
    seq_len: int,
    vocab: int,
) -> Dict[str, torch.Tensor]:
    """BST/MIND-style batch: user history (B, S), target item, label."""
    g = generator
    hist = zipf_ids(g, (batch, seq_len), vocab)
    target = zipf_ids(g, (batch,), vocab)
    # positive when the target shares a "genre" (mod-class) with the history
    genre_match = (hist % 17 == (target % 17)[:, None]).float().mean(dim=1)
    label = torch.bernoulli(torch.sigmoid(4.0 * genre_match - 1.0), generator=g)
    return {"hist": hist, "target": target, "label": label}


def retrieval_batch(
    generator: torch.Generator,
    n_candidates: int,
    embed_dim: int,
    *,
    seq_len: int = 20,
    vocab: int = 1_000_000,
) -> Dict[str, torch.Tensor]:
    """retrieval_cand shape: one user's history and the candidate bank."""
    g = generator
    hist = zipf_ids(g, (1, seq_len), vocab)
    cands = torch.randn((n_candidates, embed_dim), generator=g, device=g.device)
    return {"hist": hist, "candidates": cands}
