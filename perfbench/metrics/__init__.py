"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``: ``read(run) -> float | None`` over a
:class:`perfbench.harness.Run` (the window's round records, the engine's
spans, the traced window).  A reader that finds nothing to read returns
None, and the metric is left out of the result line."""
