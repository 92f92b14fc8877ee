"""Host utilities of the port: the per-phase Stopwatch and result export."""
