"""The pairwise tile's share of its roofline over the calls profiled with
their shapes: each launch's least time at its recorded shapes, the larger
of 2·m·n·d at the fp32 rate and its bytes at the HBM rate, summed, over the
kernel's device time in those calls."""

from cardbench import peaks


def read(rec):
    dims = rec.shapes.shapes.get("repro_torch::pairwise_distance")
    t = rec.shapes.kernel_time("pairwise_kernel")
    if not dims or t <= 0:
        return None
    bound = 0.0
    for (m, d), (n, _), norms, *_ in dims:
        flops, nbytes = peaks.pairwise_cost(m, n, d, cached_norms=bool(norms))
        bound += peaks.bound_ms(nbytes, flops)[0] * 1e-3
    return 100.0 * bound / t
