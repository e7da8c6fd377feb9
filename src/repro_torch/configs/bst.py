"""bst [arXiv:1905.06874], the Behavior Sequence Transformer (Alibaba):
embed_dim 32, 20-item history, 1 transformer block, 8 heads,
MLP 1024-512-256.  Item vocab 10^7 (taobao-scale).  Counterpart of
``repro.configs.bst``."""

from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH = "bst"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name="bst",
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp=(1024, 512, 256),
        vocab_per_field=10_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="bst", embed_dim=16, seq_len=8, n_blocks=1, n_heads=4,
        mlp=(64, 32), vocab_per_field=512,
    )
