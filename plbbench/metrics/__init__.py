"""One reader per per-layer metric, found by the metric's name:
`read(reading) -> float | None`, None where the trace holds nothing to read."""
