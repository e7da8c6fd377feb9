"""The paper's own technique, LGD (Alg. 3), as the port's main path
(counterpart of ``repro.configs.knn_lgd``).

The reference's production shape is 16.7M rows of d=128 under l2.  The port
runs it on one card at ``N_ROWS`` = 10^6 rows, the scale of the paper's
SIFT1M, Rand1M and GloVe1M sets: the whole-capacity merge of every wave makes
a build's work grow as n^2 / W, so 16.7M rows do not finish in a smoke run.
"""

from repro_torch.core.construct import BuildConfig

ARCH = "knn-lgd"
FAMILY = "knn"

# the reference's production shapes (16.7M rows, sharded); ``N_ROWS`` is
# this package's one-card cut
SHAPES = {
    "build_wave": {"kind": "knn_build", "n_total": 16_777_216, "d": 128, "wave": 4096},
    "search_4k": {"kind": "knn_search", "n_total": 16_777_216, "d": 128, "batch": 4096},
}
SKIP = {}

N_ROWS = 1_000_000
D = 128


def full_config() -> BuildConfig:
    return BuildConfig(k=20, metric="l2", wave=4096, lgd=True, beam=40, n_seeds=8)


def smoke_config() -> BuildConfig:
    # k close to the smoke set's dim (d=12, the paper's guidance) and enough
    # search budget for EHC to converge under the LGD expansion filter
    return BuildConfig(
        k=8, metric="l2", wave=64, lgd=True, beam=16, n_seeds=4,
        n_seed_init=32, hash_slots=512, max_iters=24,
    )
