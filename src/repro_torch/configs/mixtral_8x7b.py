"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d4096 32H GQA(kv=8) d_ff 14336,
vocab 32000, MoE 8 experts top-2, sliding-window attention (4096).
Counterpart of ``repro.configs.mixtral_8x7b``.
"""

from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = "mixtral-8x7b"
FAMILY = "lm"
SHAPES = LM_SHAPES
# SWA bounds the decode window — long_500k runs (reads a 4096 window/layer).
SKIP = {}


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        window=4096,
        moe=MoEConfig(n_experts=8, top_k=2),
        moe_d_ff=14336,
        tie_embeddings=False,
        rope_theta=1e6,
        param_dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        window=32,
        moe=MoEConfig(n_experts=4, top_k=2),
        moe_d_ff=128,
        tie_embeddings=False,
        remat=False,
        q_chunk=32,
        kv_chunk=32,
    )
