"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed_dim 10,
MLP 400-400-400, FM interaction.  Tables: 39 x 10^6 rows (criteo-scale).
Counterpart of ``repro.configs.deepfm``."""

from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH = "deepfm"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm",
        n_sparse=39,
        embed_dim=10,
        mlp=(400, 400, 400),
        vocab_per_field=1_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm", n_sparse=6, embed_dim=8, mlp=(32, 32), vocab_per_field=128
    )
