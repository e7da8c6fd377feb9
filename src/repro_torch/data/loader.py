"""Deterministic, skip-ahead batch loaders (counterpart of
``repro.data.loader``).

Every batch is a pure function of (seed, step): ``LoaderSpec.batch(step)``
hands ``batch_fn`` a ``torch.Generator`` on the loader's device seeded from
both (``step_seed``), so a resumed run regenerates the batches it would
have seen, from the checkpoint's step counter alone.  torch cannot replay
the reference's ``fold_in`` keys, so the numbers differ from the
reference's; ``batch_fn`` is the caller's, and ``lm_tokens`` takes its
draws as arguments so the tests can hand it the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch import device as device_lib


def step_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step``: ``seed * 0x9E3779B1 + step``
    mod 2^32.  The CPU generator keeps only 32 bits of its seed, so both
    numbers go into those bits; for one seed, distinct steps (below 2^32)
    get distinct generator seeds, and for one step, distinct seeds."""
    return (int(seed) * 0x9E3779B1 + int(step)) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LoaderSpec:
    """``batch_fn(generator) -> {name: tensor}``; ``device`` None means the
    card (raising without one)."""

    batch_fn: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    seed: int = 0
    device: Optional[object] = None

    def generator(self, step: int) -> torch.Generator:
        dev = device_lib.resolve(self.device)
        return torch.Generator(device=dev).manual_seed(step_seed(self.seed, step))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batch_fn(self.generator(step))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def lm_tokens(u: torch.Tensor, sel: torch.Tensor, vocab: int) -> torch.Tensor:
    """The reference's token transform of its draws: zipf-ish ids
    ``floor(vocab * u^3)`` from the uniforms ``u`` (B, S), and where ``sel``
    is set, the previous token + 1 (a learnable bigram structure)."""
    tokens = torch.clamp((vocab * u ** 3).to(torch.int32), max=vocab - 1)
    shift = torch.roll(tokens, 1, dims=1) + 1
    return torch.where(sel, torch.clamp(shift, max=vocab - 1), tokens)


def lm_batches(batch: int, seq: int, vocab: int, seed: int = 0, device=None) -> LoaderSpec:
    """Token batches for LM training: tokens double as labels (shift inside
    the loss)."""

    def fn(g: torch.Generator) -> Dict[str, torch.Tensor]:
        u = torch.rand((batch, seq), generator=g, device=g.device)
        sel = torch.rand((batch, seq), generator=g, device=g.device) < 0.5
        return {"tokens": lm_tokens(u, sel, vocab)}

    return LoaderSpec(batch_fn=fn, seed=seed, device=device)


def vector_waves(x: torch.Tensor, wave: int, *, start: int = 0) -> Iterator[tuple]:
    """Yield (row_start, wave_block) slices for online graph construction."""
    n = x.shape[0]
    pos = start
    while pos < n:
        w = min(wave, n - pos)
        yield pos, x[pos:pos + w]
        pos += w
