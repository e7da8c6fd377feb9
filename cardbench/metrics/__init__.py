"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``:
each has ``read(record) -> float | None`` (``harness.Record``), and returns
None when the run holds nothing to read."""
