"""Per-layer metric readers, one module per metric, found by the metric's
name: ``read(run)`` returns the metric's value, or None where the run gave it
nothing to read (the harness then leaves the metric out of the line).
``work.py`` holds the arithmetic they share."""
