"""Trackers: the one metrics/span interface every layer reports through
(counterpart of ``repro.obs.tracker``).

A tiny protocol with three implementations:

  * ``NoopTracker``     — the default everywhere; never syncs;
  * ``InMemoryTracker`` — events held in a list (tests, notebooks);
  * ``JsonlTracker``    — append-only event log on disk, one JSON object per
    line; a span tree's events are written when its depth-0 span closes, so
    no span's duration holds the log's own cost.

Two event kinds flow through a tracker:

  * **metrics** — ``log_metrics({...}, step=...)``: a flat dict of host
    scalars.  Callers convert device values themselves (``int(t)``,
    ``float(t)``) because that conversion is a host sync, and metrics are
    logged only where the code already synchronized.
  * **spans** — ``with tracker.span(name) as sp: ...; sp.sync(out)``:
    wall-clock timing of a scoped operation.  CUDA launches are
    asynchronous, so a span that closes without a sync measures the host's
    enqueue, not the card's work; ``sp.sync(tree)`` calls
    ``torch.cuda.synchronize()`` when the tree holds a CUDA tensor and marks
    the span ``synced``.  Under ``NoopTracker`` ``sync`` never blocks:
    telemetry off removes every sync it introduced.

Spans nest; each span event carries its ``depth``, its ``parent``'s name,
an integer ``id``, its ``parent_id`` (None at depth 0) and the ``root`` id
of its depth-0 span, so the JSONL round-trips back into a tree and the
spans of one call share an identifier.  While a real tracker's span is
open it also holds a profiler range of the same name
(``torch._C._profiler._RecordFunctionFast``), so under a running
``torch.profiler`` the span and the kernels launched inside it sit on one
timeline; without a profiler the range records nothing.  Trackers only read
host scalars and timestamps, so results with a tracker attached are
bit-identical to results without one.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Mapping, Optional

import numpy as np
import torch

__all__ = [
    "Tracker",
    "Span",
    "NoopTracker",
    "InMemoryTracker",
    "JsonlTracker",
    "load_events",
]


def _host_scalar(v):
    """Coerce a value to a JSON-able host scalar: python numbers, strings,
    bools, numpy scalars, 0-d arrays and tensors (a CUDA tensor here is a
    host sync; convert at the call site instead)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


def _holds_cuda(tree) -> bool:
    """Whether a tensor, or a tuple/list/dict of them (nested), lies on a
    CUDA device."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_holds_cuda(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_holds_cuda(v) for v in tree)
    return False


class Span:
    """One live span: created by ``Tracker.span``, closed by the context
    manager.  ``sync(tree)`` waits for the card when the tree holds a CUDA
    tensor (so the elapsed time covers the card's work) and returns the tree
    unchanged, letting call sites write ``res = sp.sync(res)``."""

    __slots__ = ("name", "id", "parent_id", "root", "t0", "synced")

    def __init__(self, name: str, span_id: int, parent: Optional["Span"]):
        self.name = name
        self.id = span_id
        self.parent_id = None if parent is None else parent.id
        self.root = span_id if parent is None else parent.root
        self.t0 = time.perf_counter()
        self.synced = False

    def sync(self, tree):
        if _holds_cuda(tree):
            torch.cuda.synchronize()
        self.synced = True
        return tree


class _NoopSpan:
    """Span stand-in for ``NoopTracker``: no clock read, and — critically —
    ``sync`` does NOT block: telemetry off means no telemetry-introduced
    host syncs anywhere.  ``synced`` accepts (and discards) writes so call
    sites that annotate an existing sync (``sp.synced = True``) need no
    tracker-kind branch."""

    __slots__ = ()
    name = "<noop>"

    @property
    def synced(self) -> bool:
        return False

    @synced.setter
    def synced(self, _v) -> None:
        pass

    def sync(self, tree):
        return tree


_NOOP_SPAN = _NoopSpan()


class Tracker:
    """The protocol + the span-stack machinery shared by real trackers.

    Subclasses implement ``_emit(event: dict)``; everything else —
    ``log_metrics``, the ``span`` context manager, nesting bookkeeping,
    ``finish`` — lives here so the three implementations cannot drift on
    schema.
    """

    def __init__(self):
        self._stack: List[Span] = []
        self._next_id = 1
        self._t_origin = time.perf_counter()

    # -- subclass surface ----------------------------------------------------

    def _emit(self, event: dict) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- protocol ------------------------------------------------------------

    def log_metrics(
        self, metrics: Mapping[str, object], *, step: Optional[int] = None
    ) -> None:
        """Record a flat dict of host scalars (see module doc for the
        sync-boundary policy).  ``step`` is an optional monotonic ordinal
        (wave index, serving round) for time-series readers."""
        ev = {
            "event": "metrics",
            "t": time.perf_counter() - self._t_origin,
            "metrics": {k: _host_scalar(v) for k, v in metrics.items()},
        }
        if step is not None:
            ev["step"] = int(step)
        if self._stack:
            ev["span"] = self._stack[-1].name
        self._emit(ev)

    def span(self, name: str):
        """Context manager timing a scoped operation; yields a ``Span``
        whose ``sync(tree)`` makes the measurement cover device work."""
        return _SpanCtx(self, name)

    def finish(self) -> None:
        """Flush/close; further events are a caller bug (real trackers may
        raise or drop)."""

    # -- internals shared with _SpanCtx --------------------------------------

    def _open_span(self, name: str) -> Span:
        sp = Span(name, self._next_id, self._stack[-1] if self._stack else None)
        self._next_id += 1
        self._stack.append(sp)
        return sp

    def _close_span(self, sp: Span) -> None:
        """Take ``sp`` off the stack, then emit its event: an event emitted
        with an empty stack closes a tree."""
        dur = time.perf_counter() - sp.t0
        depth = len(self._stack) - 1
        parent = self._stack[depth - 1].name if depth > 0 else None
        self._stack.pop()
        ev = {
            "event": "span",
            "name": sp.name,
            "id": sp.id,
            "parent_id": sp.parent_id,
            "root": sp.root,
            "t": sp.t0 - self._t_origin,
            "dur_s": dur,
            "depth": depth,
            "synced": sp.synced,
        }
        if parent is not None:
            ev["parent"] = parent
        self._emit(ev)


class _SpanCtx:
    """A real tracker's span and, around it, a profiler range of the same
    name: the range is entered first and left last, so on a profiler's
    timeline it holds every operator and launch the span times."""

    __slots__ = ("_tracker", "_name", "_span", "_range")

    def __init__(self, tracker: Tracker, name: str):
        self._tracker = tracker
        self._name = name
        self._span: Optional[Span] = None
        self._range = None

    def __enter__(self) -> Span:
        self._range = torch._C._profiler._RecordFunctionFast(self._name)
        self._range.__enter__()
        self._span = self._tracker._open_span(self._name)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        try:
            self._tracker._close_span(self._span)
        finally:
            self._range.__exit__(exc_type, exc, tb)
        return False


class NoopTracker(Tracker):
    """The default: accepts everything, records nothing, syncs nothing.

    ``span`` skips the stack and the clock entirely, so instrumented code
    paths cost a single attribute check when telemetry is off.
    """

    def log_metrics(self, metrics, *, step=None) -> None:
        pass

    def span(self, name: str):
        return _NOOP_CTX

    def _emit(self, event: dict) -> None:
        pass


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return _NOOP_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_CTX = _NoopCtx()

#: module-level shared no-op instance — instrumented code uses
#: ``tracker or NOOP`` so the hot path never branches on None twice
NOOP = NoopTracker()


class InMemoryTracker(Tracker):
    """Events in a host list — the test/notebook tracker.

    ``events`` is the raw chronological record; ``metrics_events`` /
    ``span_events`` are filtered views; ``spans(name)`` collects the
    durations of one span name.
    """

    def __init__(self):
        super().__init__()
        self.events: List[dict] = []

    def _emit(self, event: dict) -> None:
        self.events.append(event)

    @property
    def metrics_events(self) -> List[dict]:
        return [e for e in self.events if e["event"] == "metrics"]

    @property
    def span_events(self) -> List[dict]:
        return [e for e in self.events if e["event"] == "span"]

    def spans(self, name: str) -> List[dict]:
        return [e for e in self.span_events if e["name"] == name]


class JsonlTracker(Tracker):
    """Append-only on-disk event log: one JSON object per line.

    Crash-safety contract: the file is opened in append mode (fsync'd on
    ``finish``).  An event emitted with no span open is written and flushed
    at once; the events of a span tree are held in memory and written in
    emission order, in one write, when its depth-0 span closes.  So the
    serialization runs outside every span of the tree (a span's duration
    holds no JSON encoding of its children), and an interrupted run loses
    at most the events of the tree it was inside and a partially-written
    line — ``load_events`` skips lines that fail to parse, so a log with a
    torn tail still round-trips every complete event.  Multiple runs may
    append to one file; each tracker
    writes a ``run`` header event at open (the torch and CUDA versions, the
    card's name, and the caller's run metadata), so readers can split the
    log into runs.
    """

    def __init__(self, path: str, run_meta: Optional[dict] = None):
        super().__init__()
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._pending: List[dict] = []  # the open tree's events
        self._f = open(path, "a", encoding="utf-8")
        header = {
            "event": "run",
            "wall_time_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "pid": os.getpid(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_name": (
                torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
            ),
        }
        if run_meta:
            header["meta"] = {k: _host_scalar(v) for k, v in run_meta.items()}
        self._emit(header)

    def _emit(self, event: dict) -> None:
        if self._f is None:
            return  # post-finish emit: drop rather than crash the host loop
        self._pending.append(event)
        if not self._stack:
            self._write()

    def _write(self) -> None:
        self._f.write("".join(json.dumps(e, sort_keys=True) + "\n" for e in self._pending))
        self._f.flush()
        self._pending.clear()

    def finish(self) -> None:
        if self._f is not None:
            self._write()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __del__(self):  # best-effort close on GC
        try:
            self.finish()
        except Exception:
            pass


def load_events(path: str) -> List[dict]:
    """Parse a JSONL event log back into event dicts.

    Torn tails (a crash mid-write) and blank lines are skipped, not fatal —
    the crash-safety contract is that every *complete* line round-trips.
    """
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail / partial write
            if isinstance(ev, dict):
                events.append(ev)
    return events
