"""Shared building blocks of the recommender models (counterpart of
``repro.models.common``).

Parameters are plain nested dicts of tensors.  Every initializer takes an
explicit ``torch.Generator`` where the reference takes a PRNG key, and draws
on the generator's device; the reference's ``split_tree`` has no
counterpart, since one generator feeds the draws in a fixed order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale / sqrt(fan_in)``, fan_in the
    second-to-last dimension (the last for a vector), drawn by inverting the
    normal CDF of a uniform, as ``jax.random.truncated_normal`` does."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (x.clamp(-2.0, 2.0) * std).to(_dtype(dtype))


def embed_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (x * scale).to(_dtype(dtype))


def zeros_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    del scale
    return torch.zeros(tuple(shape), dtype=_dtype(dtype), device=generator.device)


# ---------------------------------------------------------------------------
# Normalization / activations
# ---------------------------------------------------------------------------


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The reference computes norms in fp32 and casts back; float64 inputs
    (a host-side check of the card's scores) stay float64."""
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(_compute_dtype(x))
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(x.dtype))).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(_compute_dtype(x))
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(x.dtype) + beta.to(x.dtype)).to(dt)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def mlp_stack(generator: torch.Generator, sizes: Sequence[int],
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Params for a plain MLP: sizes = [in, h1, ..., out]."""
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = dense_init(generator, (a, b), dtype)
        params[f"b{i}"] = zeros_init(generator, (b,), dtype)
    return params


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, a one-column ``w`` as a reduction over each row: BLAS's
    matrix-vector product rounds a row differently with the number of rows
    beside it, a row reduction does not, so scores computed in row chunks
    equal the whole batch's bit for bit."""
    if w.shape[-1] == 1:
        return (x * w[:, 0]).sum(dim=-1, keepdim=True)
    return x @ w


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "relu",
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    fn = ACTIVATIONS[act]
    for i in range(n):
        x = linear(x, params[f"w{i}"]) + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = fn(x)
    return x


# ---------------------------------------------------------------------------
# Losses / metrics
# ---------------------------------------------------------------------------


def _vocab_sharded(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor split over its last dimension."""
    from torch.distributed.tensor import DTensor

    return isinstance(logits, DTensor) and any(
        p.is_shard(logits.dim() - 1) for p in logits.placements)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross entropy in fp32; labels < 0 are masked (padding)."""
    logits = logits.to(_compute_dtype(logits))
    mask = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    lse = torch.logsumexp(logits, dim=-1)
    if _vocab_sharded(logits):
        # each rank sums its block of the vocabulary and one all-reduce adds
        # the blocks; the one nonzero term makes it the gathered value
        # (DTensor's gather over a sharded dimension leaves a masked partial
        # that fake tensors cannot run)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(vocab == safe[..., None], logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return torch.where(mask, loss, 0.0).sum() / mask.sum().clamp(min=1)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(_compute_dtype(logits))
    labels = labels.to(logits.dtype)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def count_params(tree) -> int:
    """Elements in a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
