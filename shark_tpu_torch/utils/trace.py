"""Read a torch.profiler Chrome trace (what --profile-dir writes): where the
card's time went, by kernel and by copy, and where each host thread's time
went, in torch operators and in CUDA runtime calls.

The port's counterpart of bench/trace_report.py, which summed a
jax.profiler trace by device op. Times in the trace are microseconds; the
summary gives milliseconds. A union counts overlapping records once (a
busy time); a sum counts each record (a total).

    summary = summarize(newest_trace(profile_dir))
    print("\\n".join(report(summary)))
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's CUDA API calls: cudaMemcpyAsync, cudaLaunchKernel,
# cudaStreamSynchronize, ... and, where the trace records them, the cu*
# calls beneath them (cuLaunchKernel)
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


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


def summarize_events(events: List[dict]) -> dict:
    """The summary of a trace's event list (see summarize)."""
    xs = [e for e in events if e.get("ph") == "X"]

    def spans(cats, tid=None):
        return [(e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
                if e.get("cat") in cats and (tid is None or e.get("tid") == tid)]

    kern = spans(("kernel",))
    window = (max(b for _, b in kern) - min(a for a, _ in kern)) if kern else 0
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
    return lines
