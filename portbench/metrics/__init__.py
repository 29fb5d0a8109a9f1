"""Per-layer metric readers, one file a metric: ``read(ctx)`` returns the
metric, or None where the run has nothing for it to read.

``ctx`` holds ``cell``, ``window`` (the measured window's counts),
``segment`` (the traced segment's counts), ``events`` and ``span`` (its
profiler events and span, see ``portbench.trace``)."""
