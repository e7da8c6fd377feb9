"""OLG (Alg. 2): the paper's construction without lazy diversification,
the ablation baseline of LGD (counterpart of ``repro.configs.knn_olg``).

The same flow as ``configs.knn_lgd`` without the λ bookkeeping or the
expansion filter, at the same widths; its one-card row count is
``knn_lgd.N_ROWS``."""

from repro_torch.core.construct import BuildConfig


def full_config() -> BuildConfig:
    return BuildConfig(k=20, metric="l2", wave=4096, lgd=False, beam=40, n_seeds=8)
