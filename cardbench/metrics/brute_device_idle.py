"""Percent of an untraced exact call with no kernel, copy or set running on
the device: the device-only pass's busy time a call over the untraced
calls' mean latency (``_common.idle_share``)."""

from cardbench.metrics._common import idle_share


def read(rec):
    return idle_share(rec)
