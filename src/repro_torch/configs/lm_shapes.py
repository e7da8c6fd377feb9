"""The shared LM-family input-shape set (seq_len x global_batch).
Counterpart of ``repro.configs.lm_shapes``."""

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

FULL_ATTENTION_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure full "
    "attention (unbounded KV window) — skipped per assignment rule, "
    "see DESIGN.md §5"
)
