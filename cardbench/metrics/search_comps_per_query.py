"""Distance computations per query, mean over every query of the window
(``SearchResult.n_comps``, the seeds' included)."""


def read(rec):
    calls = [c for c in rec.calls if "comps_sum" in c]
    q = sum(c["queries"] for c in calls)
    return sum(c["comps_sum"] for c in calls) / q if q else None
