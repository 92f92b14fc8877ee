"""Per-phase wall-clock profiler.

Copy of `pbf_sph_tpu/utils/stopwatch.py`, which mirrors the reference's
Stopwatch (reference `src/utils.hpp:15-57`): named entries, `start()` returns
a closure that records the end time, printing produces the same aligned
per-phase ms table.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


class Stopwatch:
    def __init__(self, name: str):
        self.name = name
        self.entries: List[Tuple[str, float, float]] = []

    def start(self, entry: str) -> Callable[[], None]:
        idx = len(self.entries)
        self.entries.append((entry, time.perf_counter(), 0.0))

        def stop() -> None:
            name, begin, _ = self.entries[idx]
            self.entries[idx] = (name, begin, time.perf_counter())

        return stop

    @classmethod
    def from_durations(cls, name: str, entries) -> "Stopwatch":
        """Build a table from pre-measured (entry, milliseconds) pairs: the
        CLI's `--phase-timings` fills one from the step's stage marks."""
        w = cls(name)
        for entry, ms in entries:
            w.entries.append((entry, 0.0, ms / 1000.0))
        return w

    def __str__(self) -> str:
        out = [f"Stopwatch[ {self.name}]:"]
        max_len = max((len(n) for n, _, _ in self.entries), default=0) + 3
        for name, begin, end in self.entries:
            ms = (end - begin) * 1000.0
            out.append(f"    ->`{name}` {'':>{max_len - len(name)}}: {ms:.6g}ms")
        return "\n".join(out)
