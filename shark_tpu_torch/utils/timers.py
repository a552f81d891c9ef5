"""Phase timing + throughput counters, and CUDA kernel timing.

The reference prints "[shark/<tag>] Time elapsed <s>" at phase milestones
(main.cpp:47-54); we keep that shape on stderr and add throughput counters.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch


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


def cuda_ms(fn, reps: int = 5, flush: bool = True) -> float:
    """Median time of fn() in ms on the current CUDA device: CUDA events
    around each of `reps` runs after one warm-up, with the 50 MB L2
    overwritten before every run when `flush`."""
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if flush \
        else None
    fn()
    times = []
    for _ in range(reps):
        if buf is not None:
            buf.fill_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
