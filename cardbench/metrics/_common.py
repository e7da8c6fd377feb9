"""Pieces the readers share."""


def idle_share(rec):
    """Percent of an untraced call in which nothing ran on the device: the
    device's busy time a call in the device-only pass (the union of its
    kernels, copies and sets, which the host's speed does not change), over
    the mean latency of the window's unprofiled calls.  Timing the idle time
    inside a profiled call would add the profiler's own host overhead."""
    n, lat = rec.n_device_calls, rec.latencies_s
    if n <= 0 or not lat or rec.device.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.device.busy_s / n / (sum(lat) / len(lat)))
