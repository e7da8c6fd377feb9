"""repro_torch.core — online k-NN graph construction (counterpart of
``repro.core``, with the same public names).

  * ``metrics``    — the distance registry (l2/l1/cosine/chi2/ip + registered)
  * ``brute``      — tiled exact k-NN (ground truth, seed graph)
  * ``graph``      — ``KNNGraph`` state and its invariants
  * ``search``     — batched Enhanced Hill-Climbing (Alg. 1)
  * ``construct``  — OLG (Alg. 2) / LGD (Alg. 3) wave-based online build
  * ``nndescent``  — NN-Descent and the §IV-D refinement
  * ``dynamic``    — online insert / remove (§IV-C)
  * ``hierarchy``  — the coarse landmark level
  * ``merge``      — symmetric merge of sub-graphs
  * ``segments``   — segmented group-by primitives
  * ``counters``   — exact 64-bit counters (0-d int64 tensors here)

Submodules and names load on first use: the kernels' plain versions import
``core.metrics``, so an eager import of the build here would be circular.
"""

import importlib

_MODULES = ("brute", "construct", "counters", "dynamic", "graph", "hierarchy", "merge",
            "metrics", "nndescent", "search", "segments")

# name -> (module, attribute)
_NAMES = {
    "BuildConfig": ("construct", "BuildConfig"),
    "build": ("construct", "build"),
    # a counter is a 0-d int64 tensor; ``Counter64(v)`` makes one
    "Counter64": ("counters", "counter"),
    "KNNGraph": ("graph", "KNNGraph"),
    "empty_graph": ("graph", "empty_graph"),
    "SearchConfig": ("search", "SearchConfig"),
    "brute_force_knn": ("brute", "brute_force_knn"),
    "recall_at_k": ("brute", "recall_at_k"),
}

__all__ = sorted(_MODULES + tuple(_NAMES))


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.core.{name}")
    if name in _NAMES:
        module, attr = _NAMES[name]
        return getattr(importlib.import_module(f"repro_torch.core.{module}"), attr)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
