"""Per-layer metric readers: ``metrics/<name>.py`` has ``read(run)``,
which returns the metric's value from a run's readings (``harness.Run``)
or None where there is nothing to read."""
