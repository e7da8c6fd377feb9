"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d7168 56H GQA(kv=8)
dense-FFN d_ff 4864 residual + MoE 128 experts top-2 (expert d_ff 4864).

Dense-MoE hybrid: every layer runs a (small) dense residual FFN in parallel
with the 128-expert MoE — the published Arctic topology.  Adafactor is
selected by the cell builder (optimizer state for 480B params would not fit
with Adam even sharded).
Counterpart of ``repro.configs.arctic_480b``.
"""

from repro_torch.configs.lm_shapes import LM_SHAPES, FULL_ATTENTION_SKIP
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = "arctic-480b"
FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP = {"long_500k": FULL_ATTENTION_SKIP}


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH,
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        moe=MoEConfig(n_experts=128, top_k=2),
        moe_d_ff=4864,
        dense_residual=True,
        dense_d_ff=4864,
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
        d_ff=96,
        vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2),
        moe_d_ff=96,
        dense_residual=True,
        dense_d_ff=96,
        tie_embeddings=False,
        remat=False,
        q_chunk=32,
        kv_chunk=32,
    )
