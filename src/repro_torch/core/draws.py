"""Splittable entry-point draws for the divide-and-conquer build and the
sharded router (the port's counterpart of the ``jax.random`` key chains
that ``repro.core.merge``, ``repro.core.nndescent``,
``repro.core.construct.build_parallel`` and ``repro.index.router`` thread
through their calls).

A ``Draws`` is a value, like a key: ``fold_in(i)`` and ``split()`` derive
new ones, and ``randint``/``choice``/``permutation`` read the same numbers
each time they are called on the same ``Draws``.  ``TorchDraws`` derives
its children with a 64-bit mix of integers and reads its numbers from a
``torch.Generator`` seeded with its own integer; any object with the same
five methods can be injected instead (the parity tests inject one that
replays the reference's keys).

The helpers below turn a ``Draws`` into the port's entry-point arguments in
the reference's order of draws: a search-shaped entry (``search_entry``), a
build-shaped ``seed_fn`` with one split per wave (``wave_seed_fn``), the
keyword arguments of a from-scratch build (``build_kw``) and of a coarse
level's re-derivation (``derive_kw``).
"""

from __future__ import annotations

from typing import Optional, Protocol

import torch

_MASK = (1 << 64) - 1
_SPLIT_TAGS = (1 << 40, (1 << 40) + 1)  # above any fold_in data (uint32)


class Draws(Protocol):
    def fold_in(self, data: int) -> "Draws": ...

    def split(self) -> tuple["Draws", "Draws"]: ...

    def randint(self, shape, high: int, device=None) -> torch.Tensor: ...

    def choice(self, n: int, size: int, device=None) -> torch.Tensor: ...

    def permutation(self, n: int, device=None) -> torch.Tensor: ...


def _mix(seed: int, data: int) -> int:
    """splitmix64 of (seed, data): a child seed."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class TorchDraws:
    """Draws from ``torch.Generator``s seeded along a tree of integers."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed) & _MASK

    def __repr__(self) -> str:
        return f"TorchDraws({self.seed:#x})"

    def fold_in(self, data: int) -> "TorchDraws":
        return TorchDraws(_mix(self.seed, int(data) & 0xFFFFFFFF))

    def split(self) -> tuple["TorchDraws", "TorchDraws"]:
        return tuple(TorchDraws(_mix(self.seed, t)) for t in _SPLIT_TAGS)

    def _generator(self, device) -> torch.Generator:
        return torch.Generator(device=torch.device(device or "cpu")).manual_seed(self.seed)

    def randint(self, shape, high: int, device=None) -> torch.Tensor:
        """int32 uniform over [0, max(high, 1))."""
        return torch.randint(0, max(int(high), 1), tuple(shape), generator=self._generator(device),
                             device=device, dtype=torch.int32)

    def permutation(self, n: int, device=None) -> torch.Tensor:
        return torch.randperm(n, generator=self._generator(device), device=device)

    def choice(self, n: int, size: int, device=None) -> torch.Tensor:
        """``size`` distinct ints of [0, n), int32."""
        return self.permutation(n, device)[:size].to(torch.int32)


def search_entry(draws: Draws, B: int, p: int, n_valid: int,
                 n_landmarks: Optional[int] = None, device=None):
    """What a search-shaped ``seed_fn(B, n_valid)`` returns: the (B, p) seeds
    over the allocated rows, or under coarse seeding (``n_landmarks`` given)
    the pair (seeds, coarse-pass seeds over the landmarks) from one split
    (coarse pass first, as ``repro.core.search.init_state`` splits)."""
    if n_landmarks is None:
        return draws.randint((B, p), n_valid, device)
    d_c, d_r = draws.split()
    return d_r.randint((B, p), n_valid, device), d_c.randint((B, p), n_landmarks, device)


def wave_seed_fn(draws: Draws, p: int, n_landmarks: Optional[int] = None, device=None):
    """A build-shaped ``seed_fn(wave, pos, W, n_valid)``: one split of the
    chain per wave (the wave's entry draws from the second half)."""
    subdraws = []

    def seed_fn(wave: int, pos: int, W: int, n_valid: int):
        nonlocal draws
        while len(subdraws) <= wave:
            draws, sub = draws.split()
            subdraws.append(sub)
        return search_entry(subdraws[wave], W, p, n_valid, n_landmarks, device)

    return seed_fn


def build_kw(draws: Draws, n: int, cfg, device=None) -> dict:
    """``construct.build``'s entry-point arguments for a from-scratch build
    of n rows keyed by ``draws``.  Under ``seed_mode="coarse"`` one split
    goes to the coarse level first: its landmarks are ``choice`` of the
    first half of that split, its landmark graph builds from the second."""
    if cfg.seed_mode != "coarse":
        return dict(seed_fn=wave_seed_fn(draws, cfg.n_seeds, device=device))
    from repro_torch.core import hierarchy  # late: hierarchy imports construct

    draws, d_coarse = draws.split()
    d_rows, d_graph = d_coarse.split()
    L = min(cfg.coarse_landmarks or hierarchy.default_landmarks(n), n)
    return dict(
        seed_fn=wave_seed_fn(draws, cfg.n_seeds, L, device),
        landmark_rows=d_rows.choice(n, L, device),
        landmark_seed_fn=wave_seed_fn(d_graph, cfg.n_seeds, device=device),
    )


def derive_kw(draws: Draws, g, cfg, device=None) -> dict:
    """``hierarchy.derive_coarse``'s landmark arguments keyed by ``draws``:
    ``landmark_rows``, a permutation of the alive rows (first half of one
    split), and ``seed_fn``, the landmark graph's entry points (second
    half)."""
    from repro_torch.core import hierarchy  # late: hierarchy imports construct

    rows = torch.nonzero(g.alive[: g.n_valid])[:, 0].to(device=device, dtype=torch.int32)
    L = min(cfg.coarse_landmarks or hierarchy.default_landmarks(rows.numel()), rows.numel())
    d_rows, d_graph = draws.split()
    perm = d_rows.permutation(rows.numel(), device)[:L].to(rows.device)
    return dict(landmark_rows=rows[perm.long()],
                seed_fn=wave_seed_fn(d_graph, cfg.n_seeds, device=device))
