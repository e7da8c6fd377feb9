"""Synthetic vector datasets (counterpart of ``repro.data.synthetic``).

* ``uniform``      — U[0,1)^d, intrinsic dimension d (the paper's Rand1M);
* ``clustered``    — a Gaussian mixture on a 16-dimensional linear manifold
  plus small noise (SIFT-like, low intrinsic dimension);
* ``heavy_tailed`` — Gaussian directions with power-law coordinate scales
  and Pareto row norms (GloVe-like, high intrinsic dimension);
* ``histogram``    — sparse non-negative l1-normalized rows (NUSW-like
  bag-of-visual-words, for chi2).

Each draws from an explicit ``torch.Generator`` on the device the data is
made on, with the reference's distributions and parameters; the numbers
differ from the reference's ``jax.random`` streams, so cross-package tests
feed both packages the same numpy arrays instead.  ``make(kind, generator,
n, d)`` picks one by name (``GENERATORS``).
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


def heavy_tailed(generator: torch.Generator, n: int, d: int, *, alpha: float = 1.1) -> torch.Tensor:
    """Gaussian rows with coordinate j scaled by j^(-alpha/2), each row then
    scaled by 1 + Pareto(3) (support [2, inf)): the reference's GloVe-like
    set, hard under cosine."""
    dev = generator.device
    g = torch.randn((n, d), generator=generator, device=dev)
    scales = torch.arange(1, d + 1, dtype=torch.float32, device=dev) ** (-alpha / 2.0)
    # Pareto(b) with unit scale is exp(E / b), E ~ Exp(1)
    e = torch.empty((n, 1), device=dev).exponential_(generator=generator)
    return g * scales[None, :] * (torch.exp(e / 3.0) + 1.0)


def histogram(generator: torch.Generator, n: int, d: int, *, sparsity: float = 0.1) -> torch.Tensor:
    """Bag-of-visual-words rows: Gamma(1/2) counts kept with probability
    ``sparsity``, each row normalized to unit l1 norm (non-negative, for
    chi2).  Gamma(1/2, 1) is Z^2 / 2 with Z ~ N(0, 1)."""
    dev = generator.device
    vals = torch.randn((n, d), generator=generator, device=dev) ** 2 / 2.0
    keep = torch.rand((n, d), generator=generator, device=dev) < sparsity
    x = torch.where(keep, vals, 0.0)
    return x / x.sum(dim=1, keepdim=True).clamp_min(1e-9)


GENERATORS = {
    "uniform": uniform,
    "clustered": clustered,
    "heavy_tailed": heavy_tailed,
    "histogram": histogram,
}


def make(kind: str, generator: torch.Generator, n: int, d: int, **kw) -> torch.Tensor:
    """``GENERATORS[kind](generator, n, d, **kw)``."""
    return GENERATORS[kind](generator, n, d, **kw)
