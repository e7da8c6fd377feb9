"""A whole exact call's share of its roofline: the least time of an exact
k-NN search of the call's queries over every row (2·m·n·d at the fp32 rate,
or each row, query and result moved once at the HBM rate, the larger), over
the mean time per call of the window's unprofiled calls.  It reads the same
work whatever implements the search."""

from cardbench import peaks


def read(rec):
    lat = rec.latencies_s
    if not lat:
        return None
    cfg, tr = rec.ctx.cfg, rec.ctx.traffic
    flops, nbytes = peaks.exact_search_cost(tr["queries_per_call"], cfg["n_rows"], cfg["d"],
                                            tr["top_k"])
    per_call = sum(lat) / len(lat)
    return 100.0 * peaks.bound_ms(nbytes, flops)[0] * 1e-3 / per_call
