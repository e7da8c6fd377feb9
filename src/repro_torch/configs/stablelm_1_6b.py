"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]: 24L d2048 32H (kv=32 = MHA)
d_ff 5632, vocab 100352, full attention.
Counterpart of ``repro.configs.stablelm_1_6b``.
"""

from repro_torch.configs.lm_shapes import LM_SHAPES, FULL_ATTENTION_SKIP
from repro_torch.models.transformer import TransformerConfig

ARCH = "stablelm-1.6b"
FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP = {"long_500k": FULL_ATTENTION_SKIP}


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH,
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
        tie_embeddings=False,
        rope_theta=1e4,
        param_dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        tie_embeddings=False,
        remat=False,
        q_chunk=32,
        kv_chunk=32,
    )
