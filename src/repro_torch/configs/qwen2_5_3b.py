"""qwen2.5-3b [hf:Qwen/Qwen2.5 family]: 36L d2048 16H GQA(kv=2) d_ff 11008,
vocab 151936, QKV bias, full attention, tied embeddings.
Counterpart of ``repro.configs.qwen2_5_3b``.
"""

from repro_torch.configs.lm_shapes import LM_SHAPES, FULL_ATTENTION_SKIP
from repro_torch.models.transformer import TransformerConfig

ARCH = "qwen2.5-3b"
FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP = {"long_500k": FULL_ATTENTION_SKIP}


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH,
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
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
        qkv_bias=True,
        tie_embeddings=True,
        remat=False,
        q_chunk=32,
        kv_chunk=32,
    )
