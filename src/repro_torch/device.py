"""Device resolution for the port's entry points, and the one switch that
plans the card's program on the CPU (``card_program``)."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when no CUDA device is present rather
    than carrying on silently on the CPU.  The plain versions run only when
    the caller asks for them with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


_CARD_PROGRAM = [False]


@contextlib.contextmanager
def card_program():
    """Inside, CPU tensors take the card's branches: ``kernels.ops`` sends
    them through the registered kernels (``repro_torch::*``) and
    ``attention.matmul_f32`` through the card's bf16 product.  Only the dry
    run (``configs.cells``) enters it, on fake tensors, where the kernels'
    fake forms run: a CUDA build of PyTorch could trace fake CUDA tensors,
    but a build without CUDA refuses to index them (Python indexing takes
    a CUDA device guard), so the plan's tensors are fake CPU tensors on
    every build."""
    _CARD_PROGRAM[0] = True
    try:
        yield
    finally:
        _CARD_PROGRAM[0] = False


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's branch: a CUDA tensor, or any tensor
    inside ``card_program``."""
    return t.is_cuda or _CARD_PROGRAM[0]
