"""Synthetic vector datasets (counterpart of ``repro.data.synthetic``).

* ``uniform``   — U[0,1)^d, intrinsic dimension d (the paper's Rand1M);
* ``clustered`` — a Gaussian mixture on a 16-dimensional linear manifold
  plus small noise (SIFT-like, low intrinsic dimension).

Both draw from an explicit ``torch.Generator`` on the device the data is
made on; the numbers differ from the reference's ``jax.random`` streams, so
cross-package tests feed both packages the same numpy arrays instead.
"""

from __future__ import annotations

import torch


def uniform(generator: torch.Generator, n: int, d: int) -> torch.Tensor:
    return torch.rand((n, d), generator=generator, device=generator.device)


def clustered(
    generator: torch.Generator,
    n: int,
    d: int,
    *,
    n_clusters: int = 256,
    intrinsic_dim: int = 16,
    noise: float = 0.05,
) -> torch.Tensor:
    """Clusters on a low-dimensional linear manifold plus small noise."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    basis = normal(intrinsic_dim, d) / d ** 0.5
    centers = normal(n_clusters, intrinsic_dim)
    assign = torch.randint(0, n_clusters, (n,), generator=generator, device=dev)
    z = centers[assign] + normal(n, intrinsic_dim) * 0.15
    return (z @ basis + noise * normal(n, d)).float()
