"""Exact build counters (counterpart of ``repro.core.counters``).

The JAX package keeps 64-bit counts as a carried (hi int32, lo uint32) pair
because JAX disables int64 by default.  PyTorch has int64 tensors, so a
counter here is a 0-d int64 tensor on the build's device: folding a wave's
count in is an add on the device, and reading it (``int()``) is the host
sync.  Values equal ``int(Counter64)`` of the reference.
"""

from __future__ import annotations

import torch


def counter(value: int = 0, device=None) -> torch.Tensor:
    """A 0-d int64 counter holding ``value`` (a non-negative count)."""
    value = int(value)
    if value < 0:
        raise ValueError(f"counters hold non-negative counts, got {value}")
    return torch.tensor(value, dtype=torch.int64, device=device)
