"""Synthetic vector datasets (counterpart of ``repro.data.synthetic``).

* ``uniform``   — U[0,1)^d, intrinsic dimension d (the paper's Rand1M);
* ``clustered`` — a Gaussian mixture on a 16-dimensional linear manifold
  plus small noise (SIFT-like, low intrinsic dimension).

Both draw from an explicit ``torch.Generator`` on the device the data is
made on; the numbers differ from the reference's ``jax.random`` streams, so
cross-package tests feed both packages the same numpy arrays instead.
"""

from __future__ import annotations

from typing import Optional

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
    sample_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Clusters on a low-dimensional linear manifold plus small noise.

    The manifold and the cluster centers come from ``generator``; the rows'
    clusters and noise from ``sample_generator`` when given (else from
    ``generator`` too), so rows drawn with the same ``generator`` seed and
    another ``sample_generator`` are held-out samples of the same mixture."""
    dev = generator.device
    sampler = generator if sample_generator is None else sample_generator

    def normal(*shape, g=generator):
        return torch.randn(shape, generator=g, device=dev)

    basis = normal(intrinsic_dim, d) / d ** 0.5
    centers = normal(n_clusters, intrinsic_dim)
    assign = torch.randint(0, n_clusters, (n,), generator=sampler, device=dev)
    z = centers[assign] + normal(n, intrinsic_dim, g=sampler) * 0.15
    return (z @ basis + noise * normal(n, d, g=sampler)).float()
