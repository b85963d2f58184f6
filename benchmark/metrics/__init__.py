"""One reader per per-layer metric, ``<metric name>.py``, found by the
metric's name in ``BENCHMARK.json`` and loaded from its file: each has
``read(ctx) -> float | None``; None leaves the metric out of the line."""
