"""mind [arXiv:1904.08030]: embed_dim 64, 4 interest capsules, 3 dynamic
routing iterations, label-aware attention.  Item vocab 10^7.  Counterpart
of ``repro.configs.mind``.

The retrieval_cand shape is the paper's own use case: the LGD graph over the
candidate bank serves the interests-to-items k-NN query
(``serve.retrieval``, ``examples/retrieval_serving_torch.py``)."""

from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH = "mind"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name="mind",
        embed_dim=64,
        seq_len=20,
        n_interests=4,
        capsule_iters=3,
        mlp=(256,),
        vocab_per_field=10_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="mind", embed_dim=16, seq_len=8, n_interests=4, capsule_iters=3,
        mlp=(32,), vocab_per_field=512,
    )
