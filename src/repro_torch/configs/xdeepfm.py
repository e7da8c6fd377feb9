"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim 10,
CIN 200-200-200, MLP 400-400.  Counterpart of ``repro.configs.xdeepfm``."""

from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH = "xdeepfm"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm",
        n_sparse=39,
        embed_dim=10,
        mlp=(400, 400),
        cin_layers=(200, 200, 200),
        vocab_per_field=1_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm",
        n_sparse=6,
        embed_dim=8,
        mlp=(32,),
        cin_layers=(16, 16),
        vocab_per_field=128,
    )
