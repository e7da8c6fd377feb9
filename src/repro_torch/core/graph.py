"""k-NN graph state (counterpart of ``repro.core.graph``).

Dense fixed-capacity tensors, one row per data row:

* ``nbr_ids/nbr_dist``: (cap, k) k-NN lists sorted ascending, padded with
  (-1, +inf);
* ``nbr_lam``: (cap, k) the LGD occlusion factor λ of each edge;
* ``rev_ids/rev_lam/rev_ptr``: (cap, R) reverse lists as FIFO ring buffers
  with the forward twin's λ snapshot, and the (cap,) total-append counts;
* ``alive``: (cap,) bool;
* ``n_valid``: rows [0, n_valid) are allocated — a host ``int`` here (the
  build loop advances it on the host, so reading it costs no device sync);
* ``sq_norms`` / ``row_scale``: (cap,) caches of ``‖x_i‖²`` and of the int8
  scale ``max|x_i|/127``, exact for alive allocated rows and 0 elsewhere.

Ids are int32, distances and caches float32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import segments

# float32(1/127): the scale table is a multiply by this reciprocal, the form
# the reference's compiled owners produce, so both packages give equal bits.
_INV127 = 1.0 / 127.0


class KNNGraph(NamedTuple):
    nbr_ids: torch.Tensor  # (cap, k) int32
    nbr_dist: torch.Tensor  # (cap, k) float32, sorted ascending per row
    nbr_lam: torch.Tensor  # (cap, k) int32
    rev_ids: torch.Tensor  # (cap, R) int32 ring buffer
    rev_lam: torch.Tensor  # (cap, R) int32
    rev_ptr: torch.Tensor  # (cap,) int32
    alive: torch.Tensor  # (cap,) bool
    n_valid: int
    sq_norms: torch.Tensor  # (cap,) float32
    row_scale: torch.Tensor  # (cap,) float32

    @property
    def capacity(self) -> int:
        return self.nbr_ids.shape[0]

    @property
    def k(self) -> int:
        return self.nbr_ids.shape[1]

    @property
    def rev_capacity(self) -> int:
        return self.rev_ids.shape[1]

    def to(self, device) -> "KNNGraph":
        return KNNGraph(*(
            f.to(device) if isinstance(f, torch.Tensor) else f for f in self
        ))


def empty_graph(
    capacity: int, k: int, rev_capacity: Optional[int] = None, device=None
) -> KNNGraph:
    if rev_capacity is None:
        rev_capacity = 2 * k
    i32, f32 = torch.int32, torch.float32
    return KNNGraph(
        nbr_ids=torch.full((capacity, k), -1, dtype=i32, device=device),
        nbr_dist=torch.full((capacity, k), float("inf"), dtype=f32, device=device),
        nbr_lam=torch.zeros((capacity, k), dtype=i32, device=device),
        rev_ids=torch.full((capacity, rev_capacity), -1, dtype=i32, device=device),
        rev_lam=torch.zeros((capacity, rev_capacity), dtype=i32, device=device),
        rev_ptr=torch.zeros((capacity,), dtype=i32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        n_valid=0,
        sq_norms=torch.zeros((capacity,), dtype=f32, device=device),
        row_scale=torch.zeros((capacity,), dtype=f32, device=device),
    )


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """(n, d) data -> (n,) float32 ``‖x_i‖²``: the norm cache's contents."""
    xf = x.float()
    return (xf * xf).sum(-1)


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """(n, d) data -> (n,) float32 int8 scales ``max|x_i| · float32(1/127)``."""
    inv = torch.tensor(_INV127, dtype=torch.float32, device=x.device)
    return x.float().abs().amax(dim=-1) * inv


def attach_sq_norms(g: KNNGraph, x: torch.Tensor) -> KNNGraph:
    """Fill both caches of a hand-built graph from its backing data; rows at
    or beyond ``n_valid`` and dead rows keep 0."""
    cap = g.capacity
    xs = x[:cap]
    sq = torch.zeros(cap, dtype=torch.float32, device=x.device)
    sc = torch.zeros(cap, dtype=torch.float32, device=x.device)
    sq[: xs.shape[0]] = squared_norms(xs)
    sc[: xs.shape[0]] = row_scales(xs)
    row = torch.arange(cap, device=x.device)
    allocated = (row < g.n_valid) & g.alive
    return g._replace(
        sq_norms=torch.where(allocated, sq, 0.0),
        row_scale=torch.where(allocated, sc, 0.0),
    )


def grow_graph(g: KNNGraph, new_capacity: int) -> KNNGraph:
    """Extend capacity with unallocated rows: ids -1, distances +inf, λ,
    reverse counters and caches 0, not alive."""
    extra = new_capacity - g.capacity
    if extra <= 0:
        return g
    tail = empty_graph(extra, g.k, g.rev_capacity, device=g.nbr_ids.device)
    return KNNGraph(*(
        torch.cat([a, b]) if isinstance(a, torch.Tensor) else a
        for a, b in zip(g, tail)
    ))._replace(n_valid=g.n_valid)


def trim_graph(g: KNNGraph, new_capacity: int) -> KNNGraph:
    """Drop unallocated tail rows (the inverse of ``grow_graph``); rows below
    ``n_valid`` cannot be trimmed."""
    if new_capacity >= g.capacity:
        return g
    if new_capacity < g.n_valid:
        raise ValueError(f"cannot trim below n_valid: {new_capacity} < {g.n_valid}")
    return KNNGraph(*(
        a[:new_capacity] if isinstance(a, torch.Tensor) else a for a in g
    ))


def rebuild_reverse(g: KNNGraph) -> KNNGraph:
    """Recompute the reverse lists from the forward lists: edges grouped by
    member, each member keeping its first R owners in owner order, the
    forward twin's λ riding along."""
    cap, k = g.nbr_ids.shape
    R = g.rev_capacity
    dev = g.nbr_ids.device
    owners = torch.arange(cap, dtype=torch.int32, device=dev)[:, None].expand(cap, k)
    valid = g.nbr_ids >= 0
    flat_owner = torch.where(valid, owners, cap).reshape(-1)
    flat_member = torch.where(valid, g.nbr_ids, cap).reshape(-1)
    flat_lam = torch.where(valid, g.nbr_lam, 0).reshape(-1)
    order = torch.argsort(flat_member, stable=True)
    (rev_ids, rev_lam), counts = segments.grouped_top_r(
        flat_member[order], [flat_owner[order], flat_lam[order]], [-1, 0], cap, R
    )
    return g._replace(
        rev_ids=rev_ids, rev_lam=rev_lam, rev_ptr=counts.clamp_max(R).to(torch.int32)
    )


def graph_invariants_ok(g: KNNGraph) -> dict:
    """Structural invariants; every returned bool tensor must be all True.

    Rows sorted ascending, no self loops, no duplicate ids in a row, ids in
    [0, n_valid) or -1, and no alive row referencing a dead row (forward or
    reverse)."""
    ids, dist = g.nbr_ids, g.nbr_dist
    cap, k = ids.shape
    dev = ids.device
    row = torch.arange(cap, dtype=torch.int32, device=dev)[:, None]
    sorted_ok = (dist[:, 1:] >= dist[:, :-1]).all(dim=1)
    no_self = (ids != row).all(dim=1)
    eq = (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)
    dup = eq.sum(dim=(1, 2)) > (ids >= 0).sum(dim=1)
    in_range = ((ids == -1) | ((ids >= 0) & (ids < g.n_valid))).all(dim=1)
    live_nbrs = ((ids < 0) | g.alive[ids.clamp_min(0).long()]).all(dim=1)
    live_rev = ((g.rev_ids < 0) | g.alive[g.rev_ids.clamp_min(0).long()]).all(dim=1)
    active = torch.arange(cap, device=dev) < g.n_valid
    live_row = active & g.alive
    true = torch.ones_like(active)
    return {
        "sorted": torch.where(active, sorted_ok, true),
        "no_self_loops": torch.where(active, no_self, true),
        "no_duplicates": torch.where(active, ~dup, true),
        "ids_in_range": torch.where(active, in_range, true),
        "live_neighbors": torch.where(live_row, live_nbrs, true),
        "live_reverse": torch.where(live_row, live_rev, true),
    }
