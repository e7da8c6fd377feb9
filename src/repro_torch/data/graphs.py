"""Graph data (counterpart of ``repro.data.graphs``): generators, CSR
utilities and the GraphSAGE-style neighbour sampler.

The GNN shapes span three data regimes: one fixed graph trained full-batch
(``full_graph_sm``, ``ogb_products``), a large graph trained on sampled
mini-batches (``minibatch_lg``: ``sample_neighbors``/``khop_sample``), and
batches of small molecules whose k-NN edges come from their positions
(``knn_edges_from_positions``; for large point sets the paper's online LGD
build, ``examples/molecule_graphs_torch.py``).

Every draw comes from an explicit ``torch.Generator``.  torch cannot replay
the reference's ``jax.random`` streams, so each function's draws can be
handed in instead (``u=``, ``uniforms=``, ``random_graph_from_draws``),
which is how the tests replay the reference's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class Graph(NamedTuple):
    """One static graph in edge-list + CSR form."""

    senders: torch.Tensor  # (E,) int32 src node per edge
    receivers: torch.Tensor  # (E,) int32 dst node per edge
    indptr: torch.Tensor  # (N+1,) int32 CSR row pointers (receiver-major)
    indices: torch.Tensor  # (E,) int32 CSR column ids (= senders sorted by receiver)
    features: torch.Tensor  # (N, d) float32
    labels: torch.Tensor  # (N,) int32


def csr_from_edges(senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int):
    """(indptr, indices) with edges grouped by receiver, in edge order
    within a receiver (a stable sort, as the reference's)."""
    order = torch.sort(receivers, stable=True).indices
    indices = senders[order].to(torch.int32)
    counts = torch.bincount(receivers.long(), minlength=n_nodes)
    zero = torch.zeros((1,), dtype=torch.int64, device=receivers.device)
    indptr = torch.cat([zero, torch.cumsum(counts, 0)])
    return indptr.to(torch.int32), indices


def random_graph_from_draws(u: torch.Tensor, senders: torch.Tensor, features: torch.Tensor,
                            labels: torch.Tensor, n_nodes: int, power: float = 0.8) -> Graph:
    """``random_graph`` from its draws: uniforms ``u`` (E,) for the
    receivers, sender ids, node features and labels."""
    receivers = torch.clamp((n_nodes * u ** (1.0 / (1.0 - power))).to(torch.int32),
                            max=n_nodes - 1)
    senders = senders.to(torch.int32)
    indptr, indices = csr_from_edges(senders, receivers, n_nodes)
    return Graph(senders, receivers, indptr, indices, features, labels.to(torch.int32))


def random_graph(generator: torch.Generator, n_nodes: int, n_edges: int, d_feat: int, *,
                 n_classes: int = 16, power: float = 0.8) -> Graph:
    """Power-law-ish random graph (citation-network stand-in): receiver ids
    drawn with density ~ rank^-power, so a few hub nodes have large
    in-degree.  Draws on the generator's device."""
    g, dev = generator, generator.device
    u = torch.rand((n_edges,), generator=g, device=dev)
    senders = torch.randint(0, n_nodes, (n_edges,), generator=g, device=dev)
    features = torch.randn((n_nodes, d_feat), generator=g, device=dev)
    labels = torch.randint(0, n_classes, (n_nodes,), generator=g, device=dev)
    return random_graph_from_draws(u, senders, features, labels, n_nodes, power)


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
                     fanout: int, *, generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GraphSAGE uniform-with-replacement fanout sampling over CSR rows:
    (B, fanout) int32 neighbour ids, isolated nodes sampling themselves.
    ``u`` (B, fanout) are the uniforms, else drawn from ``generator``."""
    B = seeds.shape[0]
    seeds = seeds.long()
    deg = indptr[seeds + 1] - indptr[seeds]  # (B,)
    if u is None:
        u = torch.rand((B, fanout), generator=generator, device=seeds.device)
    offs = torch.floor(u * torch.clamp(deg, min=1)[:, None]).to(torch.int32)
    slot = indptr[seeds][:, None] + offs
    nbrs = indices[torch.clamp(slot, max=indices.shape[0] - 1).long()]
    return torch.where(deg[:, None] > 0, nbrs, seeds[:, None].to(torch.int32))


def khop_sample(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
                fanouts: Sequence[int], *, generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Layered sampling: seeds -> (B, f1) -> (B, f1, f2) -> ...; returns the
    per-layer frontiers.  ``uniforms[li]`` are layer li's draws (shape
    (frontier size, f)), else drawn from ``generator``."""
    frontiers = [seeds]
    cur = seeds
    for li, f in enumerate(fanouts):
        flat = cur.reshape(-1)
        u = None if uniforms is None else uniforms[li]
        nbr = sample_neighbors(indptr, indices, flat, f, generator=generator, u=u)
        cur = nbr.reshape(tuple(cur.shape) + (f,))
        frontiers.append(cur)
    return frontiers


def molecules(generator: torch.Generator, batch: int, n_nodes: int, *, n_species: int = 8,
              box: float = 6.0) -> tuple:
    """Random molecular point clouds: positions (B, N, 3), species (B, N)."""
    g, dev = generator, generator.device
    pos = torch.rand((batch, n_nodes, 3), generator=g, device=dev) * box
    species = torch.randint(0, n_species, (batch, n_nodes), generator=g, device=dev)
    return pos, species.to(torch.int32)


def knn_edges_from_positions(pos: torch.Tensor, k: int) -> tuple:
    """Exact k-NN edges over one molecule's atom positions (N, 3):
    (senders, receivers), receivers the k-NN list owner.  Squared distances
    are sums of squared differences, as the reference's; ties go to the
    lower index, as ``lax.top_k``'s do."""
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    n = pos.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    d2 = torch.where(eye, torch.inf, d2)
    nbr = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    receivers = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=pos.device), k)
    senders = nbr.reshape(-1).to(torch.int32)
    return senders, receivers
