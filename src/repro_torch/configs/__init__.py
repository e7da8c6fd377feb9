"""Architecture registry of the port (counterpart of ``repro.configs``):
``get(arch)`` resolves ``--arch <id>`` to its config module.

Each module exports ``ARCH``, ``FAMILY``, ``SHAPES``, ``SKIP``,
``full_config()`` and ``smoke_config()`` with the reference's values.  The
registry maps the archs ported so far, the four recommender models, MACE
and the two k-NN builders; the reference's other archs (the LMs) raise,
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib
from typing import List

_ARCH_MODULES = {
    "mace": "repro_torch.configs.mace_cfg",
    "deepfm": "repro_torch.configs.deepfm",
    "bst": "repro_torch.configs.bst",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "mind": "repro_torch.configs.mind",
    # the paper's own technique as a first-class arch
    "knn-lgd": "repro_torch.configs.knn_lgd",
    "knn-olg": "repro_torch.configs.knn_olg",
}

# the reference's archs not ported yet, and the ROADMAP item that ports each
_NOT_PORTED = {
    "mixtral-8x7b": "13c", "arctic-480b": "13c", "stablelm-1.6b": "13c",
    "qwen2.5-3b": "13c", "gemma3-1b": "13c",
}


def get(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP Queue A item "
            f"{_NOT_PORTED[arch]}); ported: {sorted(_ARCH_MODULES)}"
        )
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def names(include_knn: bool = True) -> List[str]:
    return [a for a in _ARCH_MODULES if include_knn or not a.startswith("knn-")]


def all_cells(include_knn: bool = False) -> List[tuple]:
    """Every (arch, shape) pair of the ported archs, with skips annotated:
    [(arch, shape, skip_reason or None)]."""
    out = []
    for arch in names(include_knn):
        mod = get(arch)
        for shape in mod.SHAPES:
            out.append((arch, shape, mod.SKIP.get(shape)))
    return out
