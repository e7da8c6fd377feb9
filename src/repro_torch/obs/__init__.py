"""repro_torch.obs — telemetry: trackers, spans and search stats
(counterpart of ``repro.obs``).

One ``Tracker`` protocol (``log_metrics`` + ``span``), three
implementations (``NoopTracker``/``InMemoryTracker``/``JsonlTracker``), and
the ``SearchStats`` aggregator that folds per-query search signals into
scanning rate / hash saturation / comps histograms at host sync points.
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
    span_tree,
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
    "span_tree",
]
