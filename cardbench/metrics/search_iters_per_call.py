"""EHC iterations a call runs: its slowest lane's ``n_iters``, the loop's
trip count, mean over the window's calls (``SearchResult.n_iters``)."""


def read(rec):
    its = [c["iters_max"] for c in rec.calls if "iters_max" in c]
    return sum(its) / len(its) if its else None
