"""Per-layer metric readers: ``<family>.py`` reads every metric whose name
starts with ``<family>.``.  Each has ``read(trace) -> float | None`` over
the traced slice (``benchmark.lib.profile.Trace``); a reader that finds
nothing to read returns None and the metric is left out of the line."""
