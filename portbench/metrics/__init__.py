"""One reader a per-layer metric, found by the metric's name:
``read(records) -> float or None`` (None: nothing to read in this run,
and the metric is left out of the line)."""
