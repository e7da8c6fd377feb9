"""Architecture registry of the port (counterpart of ``repro.configs``):
``get(arch)`` resolves ``--arch <id>`` to its config module.

Each module exports ``ARCH``, ``FAMILY``, ``SHAPES``, ``SKIP``,
``full_config()`` and ``smoke_config()`` with the reference's values.  The
registry maps every arch of the reference, in its order: the five LMs, MACE,
the four recommender models and the two k-NN builders.  An arch listed in
``_NOT_PORTED`` would raise, naming the ROADMAP item that ports it; none is
left.
"""

from __future__ import annotations

import importlib
from typing import List

_ARCH_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
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
_NOT_PORTED: dict = {}


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
