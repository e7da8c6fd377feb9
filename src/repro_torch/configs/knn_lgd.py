"""The paper's own technique, LGD (Alg. 3), as the port's main path
(counterpart of ``repro.configs.knn_lgd``).

The reference's production shape is 16.7M rows of d=128 under l2.  The port
runs it on one card at ``N_ROWS`` = 10^6 rows, the scale of the paper's
SIFT1M, Rand1M and GloVe1M sets: the whole-capacity merge of every wave makes
a build's work grow as n^2 / W, so 16.7M rows do not finish in a smoke run.
"""

from repro_torch.core.construct import BuildConfig

N_ROWS = 1_000_000
D = 128


def full_config() -> BuildConfig:
    return BuildConfig(k=20, metric="l2", wave=4096, lgd=True, beam=40, n_seeds=8)
