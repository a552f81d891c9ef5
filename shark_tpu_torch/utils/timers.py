"""Phase timing + throughput counters.

The reference prints "[shark/<tag>] Time elapsed <s>" at phase milestones
(main.cpp:47-54); we keep that shape on stderr and add throughput counters.
"""

from __future__ import annotations

import sys
import time


class PhaseTimer:
    def __init__(self, tag: str = "shark-tpu-torch", stream=None):
        self.tag = tag
        self.start = time.monotonic()
        self.stream = stream or sys.stderr

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def mark(self, label: str) -> None:
        print(
            f"[{self.tag}/{label}] Time elapsed {int(self.elapsed())}",
            file=self.stream,
        )

    def rate(self, label: str, count: int, unit: str) -> None:
        dt = max(self.elapsed(), 1e-9)
        print(
            f"[{self.tag}/{label}] {count} {unit} in {dt:.2f}s "
            f"({count / dt:,.0f} {unit}/s)",
            file=self.stream,
        )
