"""The shared recsys input-shape set (counterpart of
``repro.configs.recsys_shapes``)."""

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65_536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": 1_000_000},
}
