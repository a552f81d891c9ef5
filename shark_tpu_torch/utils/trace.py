"""Read a torch.profiler Chrome trace (what --profile-dir writes): where the
card's time went, by kernel and by copy, where each host thread's time
went, in torch operators and in CUDA runtime calls, and in the program's
own spans (shark::<name> records, shark_tpu_torch/utils/timers.py), and
which span the dispatch thread was in while the card sat idle.

The port's counterpart of bench/trace_report.py, which summed a
jax.profiler trace by device op. Times in the trace are microseconds; the
summary gives milliseconds. A union counts overlapping records once (a
busy time); a sum counts each record (a total).

    summary = summarize(newest_trace(profile_dir))
    print("\\n".join(report(summary)))
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's CUDA API calls: cudaMemcpyAsync, cudaLaunchKernel,
# cudaStreamSynchronize, ... and, where the trace records them, the cu*
# calls beneath them (cuLaunchKernel)
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "shark::"
# the span that marks the dispatch thread: the thread that takes batches
# from the engine's ring and launches them
DISPATCH_SPAN = "ring_wait"
OUTSIDE = "outside any span"


def trace_files(profile_dir: str) -> List[str]:
    """Every *.pt.trace.json under `profile_dir`, oldest first."""
    out = []
    for dirpath, _, files in os.walk(profile_dir):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(".pt.trace.json")]
    return sorted(out, key=os.path.getmtime)


def newest_trace(profile_dir: str) -> str:
    files = trace_files(profile_dir)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {profile_dir}")
    return files[-1]


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments:
    "void (anonymous namespace)::warp_kernel<8>(Args)" -> "warp_kernel<8>"."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return n.split("(")[0].strip() or name


def _copy_kind(name: str) -> str:
    """"Memcpy HtoD (Pageable -> Device)" -> "HtoD (Pageable -> Device)"."""
    return name[len("Memcpy "):] if name.startswith("Memcpy ") else name


def _totals(events) -> Dict[str, dict]:
    """{name: {"ms": summed duration, "count", "bytes" where recorded}}."""
    out: Dict[str, dict] = {}
    for name, e in events:
        row = out.setdefault(name, {"ms": 0.0, "count": 0})
        row["ms"] += e.get("dur", 0) / 1e3
        row["count"] += 1
        nbytes = (e.get("args") or {}).get("bytes")
        if nbytes is not None:
            row["bytes"] = row.get("bytes", 0) + int(nbytes)
    return out


def _gaps(busy: List[Tuple[float, float]], t0: float, t1: float):
    """The parts of (t0, t1) outside every busy span, in order."""
    out, at = [], t0
    for a, b in sorted(busy):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(gaps: List[Tuple[float, float]],
                 spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """{span name: time} of the `gaps` (sorted, apart), each instant given
    to the innermost of the (start, end, name) `spans` of one thread open
    at that instant (the latest begun), else to OUTSIDE."""
    starts = [a for a, _ in gaps]
    cum = [0.0]
    for a, b in gaps:
        cum.append(cum[-1] + b - a)

    def idle_to(t):  # gap time before t
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        a, b = gaps[k - 1]
        return cum[k - 1] + min(t, b) - a

    events = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    out: Dict[str, float] = {}
    opened: List[int] = []
    at = gaps[0][0] if gaps else 0.0
    for t, starting, i in events:
        if t > at:
            label = spans[opened[-1]][2] if opened else OUTSIDE
            out[label] = out.get(label, 0.0) + idle_to(t) - idle_to(at)
            at = t
        if starting:
            opened.append(i)
        else:
            opened.remove(i)
    if gaps and gaps[-1][1] > at:
        out[OUTSIDE] = out.get(OUTSIDE, 0.0) + cum[-1] - idle_to(at)
    return {k: v for k, v in out.items() if v > 0}


def summarize_events(events: List[dict]) -> dict:
    """The summary of a trace's event list (see summarize)."""
    xs = [e for e in events if e.get("ph") == "X"]

    def spans(cats, tid=None):
        return [(e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
                if e.get("cat") in cats and (tid is None or e.get("tid") == tid)]

    kern = spans(("kernel",))
    window = (max(b for _, b in kern) - min(a for a, _ in kern)) if kern else 0
    marks = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX)]
    by_thread: Dict[str, Dict[str, dict]] = {}
    for e in marks:
        row = by_thread.setdefault(str(e.get("tid")), {}).setdefault(
            e["name"][len(SPAN_PREFIX):], {"n": 0, "ms": 0.0})
        row["n"] += 1
        row["ms"] += e.get("dur", 0) / 1e3
    dispatch = next((t for t, rows in by_thread.items()
                     if DISPATCH_SPAN in rows), None)
    idle = {}
    if kern:
        gaps = _gaps(spans(DEVICE_CATS), min(a for a, _ in kern),
                     max(b for _, b in kern))
        idle = idle_by_span(gaps, [
            (e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(SPAN_PREFIX):])
            for e in marks if str(e.get("tid")) == dispatch])
    host = {}
    tids = {e.get("tid") for e in xs
            if e.get("cat") in ("cpu_op",) + RUNTIME_CATS}
    for tid in sorted(tids, key=str):
        ops = spans(("cpu_op",), tid)
        rt = spans(RUNTIME_CATS, tid)
        both = ops + rt
        calls: Dict[str, float] = {}
        for e in xs:
            if e.get("cat") in RUNTIME_CATS and e.get("tid") == tid:
                calls[e["name"]] = calls.get(e["name"], 0) + e.get("dur", 0)
        span = max(b for _, b in both) - min(a for a, _ in both)
        busy = union_us(both)
        host[str(tid)] = {
            "ops_ms": union_us(ops) / 1e3,
            "runtime_ms": union_us(rt) / 1e3,
            "runtime_calls_ms": {k: v / 1e3 for k, v in sorted(
                calls.items(), key=lambda kv: -kv[1])},
            "top_runtime_ms": {k: v / 1e3 for k, v in sorted(
                calls.items(), key=lambda kv: -kv[1])[:3]},
            "window_ms": span / 1e3,
            "outside_ms": (span - busy) / 1e3,
        }
    return {
        "kernels": len(kern),
        "kernel_busy_ms": union_us(kern) / 1e3,
        "device_busy_ms": union_us(spans(DEVICE_CATS)) / 1e3,
        "window_ms": window / 1e3,
        "by_kernel": _totals((short_name(e["name"]), e) for e in xs
                             if e.get("cat") == "kernel"),
        "memcpy": _totals((_copy_kind(e["name"]), e) for e in xs
                          if e.get("cat") == "gpu_memcpy"),
        "memset": _totals(("memset", e) for e in xs
                          if e.get("cat") == "gpu_memset").get(
                              "memset", {"ms": 0.0, "count": 0}),
        "host": host,
        "spans": by_thread,
        "dispatch_thread": dispatch,
        "idle_by_span_ms": {k: v / 1e3 for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
    }


def summarize(path: str) -> dict:
    """A Chrome trace summed:
    - "kernels" (records), "kernel_busy_ms" (their union), "device_busy_ms"
      (the union of kernels, copies and memsets), "window_ms" (the first
      kernel's start to the last kernel's end; 0 without kernels);
    - "by_kernel": {short name: {"ms", "count"}};
    - "memcpy": {kind as "HtoD (Pageable -> Device)": {"ms", "count",
      "bytes"}}, "memset": {"ms", "count"};
    - "host": {thread id: {"ops_ms" (union of torch operators),
      "runtime_ms" (union of its CUDA API calls),
      "runtime_calls_ms" ({call: summed ms}), "top_runtime_ms" (its three
      largest), "window_ms" (the thread's first record to its last),
      "outside_ms" (that window outside both)}} for every thread that ran
      a torch operator or a CUDA call;
    - "spans": {thread id: {span name: {"n", "ms"}}} of the program's
      shark::<name> records; "dispatch_thread": the thread id of the
      shark::ring_wait records, or None;
    - "idle_by_span_ms": the card's idle time in the window (no kernel,
      copy or memset), each instant given to the dispatch thread's
      innermost span open then, or to "outside any span";
    - "trace" (file name) and "trace_mb"."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = summarize_events(events)
    out["trace"] = os.path.basename(path)
    out["trace_mb"] = os.path.getsize(path) / 1e6
    return out


def report(s: dict, top: int = 15) -> List[str]:
    """The summary as text lines: the card, its kernels by time, copies and
    memsets, then each host thread."""
    win = s["window_ms"]
    pct = (lambda x: f" ({100 * x / win:.2f}% of the window)") if win else (
        lambda x: "")
    lines = [
        f"trace {s.get('trace', '')} ({s.get('trace_mb', 0):.1f} MB)",
        f"card: {s['kernels']} kernel records, busy {s['kernel_busy_ms']:.3f}"
        f" ms{pct(s['kernel_busy_ms'])}; with copies and memsets "
        f"{s['device_busy_ms']:.3f} ms{pct(s['device_busy_ms'])}; window "
        f"{win:.3f} ms (first kernel to last)",
    ]
    for name, r in sorted(s["by_kernel"].items(),
                          key=lambda kv: -kv[1]["ms"])[:top]:
        lines.append(f"  kernel {r['ms']:10.3f} ms {r['count']:6d}x  {name}")
    for kind, r in sorted(s["memcpy"].items(), key=lambda kv: -kv[1]["ms"]):
        mb = f", {r['bytes'] / 1e6:.2f} MB" if "bytes" in r else ""
        lines.append(f"  memcpy {r['ms']:10.3f} ms {r['count']:6d}x  "
                     f"{kind}{mb}")
    m = s["memset"]
    lines.append(f"  memset {m['ms']:10.3f} ms {m['count']:6d}x")
    for tid, h in s["host"].items():
        calls = ", ".join(f"{k} {v:.1f}" for k, v in list(
            h["runtime_calls_ms"].items())[:6])
        lines.append(
            f"host thread {tid}: window {h['window_ms']:.1f} ms, torch "
            f"operators {h['ops_ms']:.1f} ms, CUDA calls "
            f"{h['runtime_ms']:.1f} ms, outside both {h['outside_ms']:.1f} "
            f"ms" + (f" (CUDA calls: {calls})" if calls else ""))
    for tid, rows in s["spans"].items():
        role = " (dispatch)" if tid == s["dispatch_thread"] else ""
        lines.append(f"spans of thread {tid}{role}: " + ", ".join(
            f"{k} {r['n']}x {r['ms']:.3f} ms" for k, r in sorted(
                rows.items(), key=lambda kv: -kv[1]["ms"])))
    if s["idle_by_span_ms"]:
        lines.append("card idle in the window, by the dispatch thread's "
                     "span: " + ", ".join(
                         f"{k} {v:.3f} ms"
                         for k, v in s["idle_by_span_ms"].items()))
    return lines
