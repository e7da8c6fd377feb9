"""OLG (Alg. 2): the paper's construction without lazy diversification,
the ablation baseline of LGD (counterpart of ``repro.configs.knn_olg``).

The same flow as ``configs.knn_lgd`` without the λ bookkeeping or the
expansion filter, at the same widths; its one-card row count is
``knn_lgd.N_ROWS``."""

from repro_torch.core.construct import BuildConfig

ARCH = "knn-olg"
FAMILY = "knn"

# the reference's production shapes (16.7M rows, sharded); ``N_ROWS`` is
# this package's one-card cut
SHAPES = {
    "build_wave": {"kind": "knn_build", "n_total": 16_777_216, "d": 128, "wave": 4096},
    "search_4k": {"kind": "knn_search", "n_total": 16_777_216, "d": 128, "batch": 4096},
}
SKIP = {}


def full_config() -> BuildConfig:
    return BuildConfig(k=20, metric="l2", wave=4096, lgd=False, beam=40, n_seeds=8)


def smoke_config() -> BuildConfig:
    return BuildConfig(
        k=5, metric="l2", wave=64, lgd=False, beam=12, n_seeds=4,
        n_seed_init=32, hash_slots=256, max_iters=12,
    )
