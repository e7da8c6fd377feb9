"""Percent of the traced exact calls' device time spent outside the
pairwise tile: the running top-k (``tile_topk``, one launch a tile), the
fills of the empty best, the last tile's zero padding and the copies."""


def read(rec):
    tr = rec.device
    total = sum(tr.kernel_s.values())
    if total <= 0 or tr.kernel_time("pairwise_kernel") <= 0:
        return None
    return 100.0 * (1.0 - tr.kernel_time("pairwise_kernel") / total)
