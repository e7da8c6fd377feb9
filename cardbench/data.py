"""The benchmark's data: a configuration's catalog and a run's queries.

Frozen copies of the port's ``clustered`` (SIFT-like) and ``heavy_tailed``
(GloVe-like) generators (``repro_torch.data.synthetic``), so that a later
change to the program's generators cannot change what is measured.  Both
draw on the device from explicit ``torch.Generator``s.

The catalog is the deployment's data set: it comes from the configuration's
``dataset_seed``, as ANN-benchmarks serves one fixed base set, so every run
of a configuration indexes the same rows and its set-up can restore the
index from a snapshot.  The queries are held-out draws of the same
distribution, from the configuration's ``dataset_seed`` where the traffic
uses a fixed query set (a published set is one file) and from ``--seed``
otherwise (for ``clustered``, the same mixture: the manifold
and the centres are redrawn from the dataset seed, the rows' clusters and
noise from the query seed).
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any whole
    number, larger than 32 bits included)."""
    h = hashlib.sha256(f"{tag}:{int(seed)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def clustered(gen, n, d, *, n_clusters=256, intrinsic_dim=16, noise=0.05, sample_gen=None):
    """Clusters on a low-dimensional linear manifold plus small noise; the
    manifold and centres from ``gen``, the rows from ``sample_gen`` when
    given (held-out rows of the same mixture)."""
    dev = gen.device
    sampler = gen if sample_gen is None else sample_gen

    def normal(*shape, g=gen):
        return torch.randn(shape, generator=g, device=dev)

    basis = normal(intrinsic_dim, d) / d ** 0.5
    centers = normal(n_clusters, intrinsic_dim)
    assign = torch.randint(0, n_clusters, (n,), generator=sampler, device=dev)
    z = centers[assign] + normal(n, intrinsic_dim, g=sampler) * 0.15
    return (z @ basis + noise * normal(n, d, g=sampler)).float()


def heavy_tailed(gen, n, d, *, alpha=1.1, sample_gen=None):
    """Gaussian rows with coordinate j scaled by j^(-alpha/2), each row then
    scaled by 1 + Pareto(3); rows are independent, so held-out rows are
    simply drawn from ``sample_gen``."""
    g = gen if sample_gen is None else sample_gen
    dev = g.device
    rows = torch.randn((n, d), generator=g, device=dev)
    scales = torch.arange(1, d + 1, dtype=torch.float32, device=dev) ** (-alpha / 2.0)
    e = torch.empty((n, 1), device=dev).exponential_(generator=g)
    return rows * scales[None, :] * (torch.exp(e / 3.0) + 1.0)


GENERATORS = {"clustered": clustered, "heavy_tailed": heavy_tailed}


def catalog(cfg: dict, device) -> torch.Tensor:
    """The configuration's (n_rows, d) float32 base set."""
    gen = generator(device, cfg["dataset_seed"], "catalog")
    return GENERATORS[cfg["data"]](gen, cfg["n_rows"], cfg["d"])


def query_seed(cfg: dict, traffic: dict, run_seed: int) -> int:
    """The seed of a traffic's queries: the configuration's fixed held-out
    set (``query_set: fixed``) or the run's own draw (``run``)."""
    kind = traffic["query_set"]
    if kind not in ("fixed", "run"):
        raise KeyError(f"query_set must be 'fixed' or 'run', not {kind!r}")
    return cfg["dataset_seed"] if kind == "fixed" else run_seed


def queries(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    """(n, d) float32 held-out queries of the configuration's distribution,
    drawn from run seed ``seed``."""
    gen = generator(device, cfg["dataset_seed"], "catalog")
    sample = generator(device, seed, "queries")
    return GENERATORS[cfg["data"]](gen, n, cfg["d"], sample_gen=sample)
