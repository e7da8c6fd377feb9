"""The traced part of a run: ``torch.profiler`` over a few calls, its
timeline exported and read back.

A traced run profiles in two passes.  The first call(s) run under a
profiler that records the host's operators and their input shapes
(``profiler(shapes=True)``): the shapes of the registered
``repro_torch::*`` kernels, and the idle gaps named by what the host was
doing in them.  That recording slows the host loop, so the device's busy
and idle share come from the next calls, profiled for device activity
alone (``profiler(shapes=False)``), over a window timed on the host.

``Trace`` holds what the per-layer readers take: the device's busy time
(the union of kernel, copy and set intervals) and the window's length,
device time by kernel name, the recorded input shapes, and the gaps.
"""

from __future__ import annotations

import collections
import heapq
import json
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def profiler(shapes: bool):
    """The host's operators with their shapes and the device (``shapes``),
    or the device alone; None where there is neither to record."""
    acts = [torch.profiler.ProfilerActivity.CPU] if shapes else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if not acts:
        return None
    return torch.profiler.profile(activities=acts, record_shapes=shapes)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Read from an exported chrome trace; times in seconds.  Without
    ``window_s`` the window is bounded on the trace's clock (µs) by the
    spans of the benchmark's ``cardbench/`` annotations, from the first
    traced call's submit to the last one's ids on the host.  With it (a
    device-only trace, timed on the host around calls that start and end
    with the device idle) every device interval counts."""

    def __init__(self, path=None, window_s=None):
        events = []
        if path is not None:
            with open(path) as f:
                events = [e for e in json.load(f).get("traceEvents", [])
                          if e.get("ph") == "X" and "dur" in e]
        calls = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("cardbench/")]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        if window_s is not None:
            t0 = min((e["ts"] for e in dev), default=0.0)
            t1 = max((e["ts"] + e["dur"] for e in dev), default=0.0)
        elif calls:
            t0 = min(e["ts"] for e in calls)
            t1 = max(e["ts"] + e["dur"] for e in calls)
        else:
            t0 = t1 = 0.0
        self.window_s = (t1 - t0) * 1e-6 if window_s is None else window_s
        busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev
                       if e["ts"] < t1 and e["ts"] + e["dur"] > t0])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.kernel_s = collections.Counter()
        for e in dev:
            self.kernel_s[e["name"]] += e["dur"] * 1e-6
        self.shapes = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op" and "Input Dims" in e.get("args", {}):
                self.shapes[e["name"]].append(e["args"]["Input Dims"])
        self.gaps = self._gaps(busy, t0, t1)

    def kernel_time(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds ``fragment``."""
        return sum(s for name, s in self.kernel_s.items() if fragment in name)

    def _gaps(self, busy, t0, t1):
        """Idle seconds by the innermost host event under each gap's middle."""
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        host = sorted(self.host, key=lambda e: e["ts"])
        active, nxt = [], 0  # heap of (end, start, name) of started events
        by = collections.Counter()
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            while nxt < len(host) and host[nxt]["ts"] <= mid:
                h = host[nxt]
                heapq.heappush(active, (h["ts"] + h["dur"], h["ts"], h["name"]))
                nxt += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = max(active, key=lambda a: a[1])[2] if active else "host: between ops"
            by[name] += (e - s) * 1e-6
        return by

    def breakdown(self, device=None) -> dict:
        """The longest device operations (of ``device``'s trace where given)
        and the longest idle gaps by the host's operator."""
        ops = (device if device is not None and device.kernel_s else self).kernel_s
        return {
            "device_ops": [[n[:120], s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n[:120], s] for n, s in self.gaps.most_common(TOP)],
        }
