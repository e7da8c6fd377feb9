"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d1152 4H GQA(kv=1) head_dim 256,
d_ff 6912, vocab 262144, 5:1 local:global attention (local window 512),
128k context, tied embeddings.
Counterpart of ``repro.configs.gemma3_1b``.
"""

from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH = "gemma3-1b"
FAMILY = "lm"
SHAPES = LM_SHAPES
# 5:1 local:global — decode reads a bounded window on 5/6 of layers, so the
# long_500k cell runs (the single global layer per period is O(S) decode).
SKIP = {}


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH,
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_head=256,
        d_ff=6912,
        vocab=262144,
        local_global=(5, 1),
        local_window=512,
        tie_embeddings=True,
        rope_theta=1e6,
        logit_softcap=30.0,
        param_dtype="bfloat16",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH + "-smoke",
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_head=32,
        d_ff=128,
        vocab=256,
        local_global=(2, 1),
        local_window=16,
        tie_embeddings=True,
        logit_softcap=30.0,
        remat=False,
        q_chunk=32,
        kv_chunk=32,
    )
