"""PyTorch/CUDA port of the online k-NN graph construction (OLG/LGD).

The layout mirrors the JAX package ``repro``: ``core`` holds the graph state,
brute force, EHC search, the batched merge and the wave-by-wave build;
``kernels`` holds the three hand-written CUDA kernels (``csrc/``), their
plain PyTorch versions and the one routing point between them
(``kernels.ops``).  A tensor on the CPU takes the plain version; a tensor on
a CUDA device takes the kernel.  Entry points (``core.construct.build``,
``core.search.search``, ``core.brute.brute_force_knn``, the launcher) run on
``cuda`` unless the caller passes ``device="cpu"``.

The facade exports the reference's top-level names, each imported on first
use so that ``import repro_torch`` stays light::

    import repro_torch

    g, stats = repro_torch.build(x, repro_torch.BuildConfig(k=20))
    idx = repro_torch.OnlineIndex.build(x, repro_torch.BuildConfig(k=20))
    res = idx.search(queries, top_k=10)
"""

import importlib

__version__ = "0.9.0"  # the version of the reference's API this facade mirrors

# name -> the module that defines it
_EXPORTS = {
    "BuildConfig": "repro_torch.core.construct",
    "build": "repro_torch.core.construct",
    "build_parallel": "repro_torch.core.construct",
    "SearchConfig": "repro_torch.core.search",
    "SearchResult": "repro_torch.core.search",
    "search": "repro_torch.core.search",
    "OnlineIndex": "repro_torch.index.lifecycle",
    "ShardedIndex": "repro_torch.index.router",
    "Tracker": "repro_torch.obs",
    "NoopTracker": "repro_torch.obs",
    "InMemoryTracker": "repro_torch.obs",
    "JsonlTracker": "repro_torch.obs",
    "SearchStats": "repro_torch.obs",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + __all__)
