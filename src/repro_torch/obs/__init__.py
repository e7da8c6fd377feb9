"""repro_torch.obs — telemetry: trackers, spans and search stats
(counterpart of ``repro.obs``).

One ``Tracker`` protocol (``log_metrics`` + ``span``), three
implementations (``NoopTracker``/``InMemoryTracker``/``JsonlTracker``), and
the ``SearchStats`` aggregator that folds per-query search signals into
comps per query, scanning rate and hash saturation at host sync points.
"""

from repro_torch.obs.stats import SearchStats
from repro_torch.obs.tracker import (
    NOOP,
    InMemoryTracker,
    JsonlTracker,
    NoopTracker,
    Span,
    Tracker,
    load_events,
)

__all__ = [
    "Tracker",
    "Span",
    "NoopTracker",
    "InMemoryTracker",
    "JsonlTracker",
    "SearchStats",
    "NOOP",
    "load_events",
]
