"""Phase timing + throughput counters, the spans of a pipeline pass, and
CUDA kernel timing: CUDA events, and torch.profiler device time held
against the back-to-back event time, with the L2 warm or flushed.

The reference prints "[shark/<tag>] Time elapsed <s>" at phase milestones
(main.cpp:47-54); we keep that shape on stderr and add throughput counters.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import threading
import time
from typing import Callable, Dict, Optional

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


class Spans:
    """The spans of one pass of the pipeline: for each name, how many
    times the code it wraps ran and the time.perf_counter_ns time it took,
    plus plain counts (`counts`). Each thread that records (recording())
    gets its own totals, so no update races another thread's; summary()
    adds them up. When a torch.profiler session is recording as the pass
    begins, every span also opens torch.profiler.record_function(
    "shark::<name>"), which the Chrome trace keeps as a user_annotation
    record on the card's clock; with none, no record_function is made."""

    def __init__(self):
        # the module's flag is set for a session in any mode; the
        # thread's own flag is not set where the session records every
        # thread (all_threads_config)
        self.profiled = bool(
            getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled()
        )
        self.counts: Dict[str, int] = {}
        self._threads = []  # (role, _ThreadSpans)

    def thread(self, role: str) -> "_ThreadSpans":
        t = _ThreadSpans(self.profiled)
        self._threads.append((role, t))
        return t

    def summary(self) -> dict:
        """{name: {"n": count, "ms": total}} over every thread."""
        out: Dict[str, dict] = {}
        for _, t in self._threads:
            for name, (n, ns) in t.totals.items():
                row = out.setdefault(name, {"n": 0, "ms": 0.0})
                row["n"] += n
                row["ms"] += ns / 1e6
        return out

    def covered_ms(self) -> dict:
        """{role: ms} inside the outermost spans of each role's threads
        (a span within another counts once)."""
        out: Dict[str, float] = {}
        for role, t in self._threads:
            out[role] = out.get(role, 0.0) + t.outer_ns / 1e6
        return out

    def n(self, name: str) -> int:
        return self.summary().get(name, {"n": 0})["n"]


class _ThreadSpans:
    """One thread's share of a pass's spans."""

    __slots__ = ("totals", "depth", "outer_ns", "profiled")

    def __init__(self, profiled: bool):
        self.totals: Dict[str, list] = {}  # name -> [n, ns]
        self.depth = 0
        self.outer_ns = 0
        self.profiled = profiled


class _Span:
    __slots__ = ("rec", "name", "t0", "fn")

    def __init__(self, rec: _ThreadSpans, name: str):
        self.rec = rec
        self.name = name
        self.fn = None

    def __enter__(self):
        rec = self.rec
        if rec.profiled:
            self.fn = torch.profiler.record_function("shark::" + self.name)
            self.fn.__enter__()
        rec.depth += 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        rec = self.rec
        rec.depth -= 1
        if rec.depth == 0:
            rec.outer_ns += dt
        tot = rec.totals.get(self.name)
        if tot is None:
            rec.totals[self.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


_local = threading.local()
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that adds the time of its body to `name` in the
    pass this thread records into (recording()); a no-op outside one."""
    rec = getattr(_local, "rec", None)
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name)


def all_threads_config():
    """A torch.profiler experimental_config that records the torch calls
    and spans of every thread, not only of the thread that starts the
    profiler (the pipeline's drain runs on a thread of its own); None
    where this torch lacks the setting."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def recording(spans: Spans, role: str):
    """Within it, span() on this thread records into `spans` as one of
    `role`'s threads ("dispatch", "drain")."""
    prev = getattr(_local, "rec", None)
    _local.rec = spans.thread(role)
    try:
        yield
    finally:
        _local.rec = prev


def l2_flusher(nbytes: int = 128 << 20, device="cuda"):
    """A function that overwrites `nbytes` of device memory (default 128
    MB, over twice the H100's 50 MB L2), so that the next kernel finds
    nothing of its inputs in the L2."""
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return lambda: buf.fill_(1)


def cuda_ms(fn, reps: int = 5, flush: bool = True) -> float:
    """Median time of fn() in ms on the current CUDA device: CUDA events
    around each of `reps` runs after one warm-up, with the L2 overwritten
    (l2_flusher) before every run when `flush`."""
    flusher = l2_flusher() if flush else None
    fn()
    times = []
    for _ in range(reps):
        if flusher is not None:
            flusher()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def op_name(key: str) -> str:
    """A profiler record's kernel name without its namespace and
    arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].strip() \
        or key


def device_records(prof):
    """(event, self device µs over all its records) of each kernel or
    memset a torch.profiler session recorded."""
    out = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
        if t > 0 and e.count > 0:
            out.append((e, t))
    return out


def profile_session(fn, reps: int, flush: Optional[Callable] = None,
                    names=None):
    """(device ms of one fn() call, {op: device ms per call}) from one
    torch.profiler session over `reps` calls, each after flush() when
    given. Each kernel or memset's self time is divided by its records,
    since a session may miss the records of some calls, then multiplied
    by the records a call makes (rounded), so that two memsets of one
    call both count. Only the ops in `names` count when it is given, so
    that the flush's own kernel stays out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e, t in device_records(prof):
        name = op_name(e.key)
        if names is not None and name not in names:
            continue
        per_call = max(1, round(e.count / reps))
        ops[name] = ops.get(name, 0.0) + t / e.count * per_call / 1e3
    return sum(ops.values()), ops


def queue_ms(fn, n: int = 20):
    """(back-to-back ms, host ms) of one fn() call: n calls queued back to
    back between two CUDA events after one warm-up, L2 warm, and the
    host's clock over the same loop (no synchronisation inside it). The
    first is the device time of one call when its kernels take longer
    than the host needs to queue them; the second is then the smaller."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, (t1 - t0) / n * 1e3


def back_to_back_ms(fn, n: int = 20) -> float:
    """The back-to-back time of queue_ms."""
    return queue_ms(fn, n)[0]


def device_profile(fn, reps: int = 7, flush: Optional[Callable] = None,
                   warn: Callable[[str], None] = print) -> dict:
    """Device time of one fn() call, held against the back-to-back event
    time of the same call: {"device_ms", "device_ops" (ms per kernel or
    memset), "back_to_back_ms", "host_ms"}. The least of three profiler
    sessions (a session may also record work queued before it, such as
    another timer's L2 flush). With `flush` (l2_flusher) every call of a
    session follows flush(), and only the ops that a session without it
    records count. Where the card, not the host, sets the back-to-back
    time (it is over 1.25x the host's time to queue the same calls, taken
    in the same loop), that time is device time plus launch gaps with the
    L2 warm, so a session under 0.8x of it has lost records: it is
    dropped, and up to three more sessions are taken. If none agrees, the
    result keeps the least reading and gains "device_ms_suspect" with
    every reading, and warn() says so; a low reading is never kept
    silently. device_ms is None when no session records device time."""
    fn()
    torch.cuda.synchronize()
    names = set(profile_session(fn, reps)[1]) if flush is not None else None

    def session():
        return profile_session(fn, reps, flush, names)

    sessions = [session() for _ in range(3)]
    b2b, host = queue_ms(fn)
    queued = b2b > 1.25 * host

    def agrees(s):
        return s[0] > 0 and (not queued or s[0] >= 0.8 * b2b)

    for _ in range(3):
        if any(agrees(s) for s in sessions) or not queued:
            break
        sessions.append(session())
    out = {"device_ms": None, "back_to_back_ms": b2b, "host_ms": host}
    recorded = [s for s in sessions if s[0] > 0]
    if not recorded:
        return out
    good = [s for s in recorded if agrees(s)]
    best = min(good or recorded, key=lambda s: s[0])
    out["device_ms"], out["device_ops"] = best
    if not good:
        out["device_ms_suspect"] = {
            "sessions_ms": [s[0] for s in recorded], "back_to_back_ms": b2b,
            "host_ms": host}
        warn(f"device_ms suspect: every profiler reading "
             f"{[round(s[0], 4) for s in recorded]} ms is under 0.8x the "
             f"back-to-back time {b2b:.4f} ms (host {host:.4f} ms a call)")
    return out
