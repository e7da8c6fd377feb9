"""PyTorch/CUDA port of the online k-NN graph construction (OLG/LGD).

The layout mirrors the JAX package ``repro``: ``core`` holds the graph state,
brute force, EHC search, the batched merge and the wave-by-wave build;
``kernels`` holds the three hand-written CUDA kernels (``csrc/``), their
plain PyTorch versions and the one routing point between them
(``kernels.ops``).  A tensor on the CPU takes the plain version; a tensor on
a CUDA device takes the kernel.  Entry points (``core.construct.build``,
``core.search.search``, ``core.brute.brute_force_knn``, the launcher) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""


def __getattr__(name):
    # ``repro_torch.build`` / ``repro_torch.BuildConfig``, as the reference
    # exports them, without importing the build when the package is imported
    if name in ("build", "BuildConfig"):
        from repro_torch.core import construct

        return getattr(construct, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
