"""A torch.profiler Chrome trace reduced to the benchmark's numbers: the
device's busy time (the union of its kernel, copy and memset records),
kernel time by name, and the idle gaps labelled by what the host was
doing. The union and the kernel short names follow the port's trace
reader (shark_tpu_torch/utils/trace.py), frozen here so that a change to
the program cannot move the yardstick."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NO_CALL = "no torch or CUDA call (C++ engine, drain or Python)"


def short_name(name: str) -> str:
    """"void (anonymous namespace)::warp_kernel<8>(Args)" -> "warp_kernel<8>"."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return n.split("(")[0].strip() or name


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Overlapping (start, end) spans merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def load(path: str) -> List[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def summarize(events: List[dict], top: int = 10, labelled: int = 400) -> dict:
    """{"window_s", "busy_s", "kernel_s", "by_op" [[name, s], ...] (the
    device operations that took most time), "idle_gaps" [[label, s], ...]
    (idle time summed by the host call that overlaps each gap most, over
    the `labelled` longest gaps)}. The window runs from the first record
    of any kind to the last."""
    if not events:
        return {"window_s": 0.0, "busy_s": 0.0, "kernel_s": 0.0,
                "by_op": [], "idle_gaps": []}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0) for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev]
    by_op: Dict[str, float] = {}
    kernel_us = 0.0
    for e in dev:
        name = (short_name(e["name"]) if e["cat"] == "kernel"
                else e["name"])
        by_op[name] = by_op.get(name, 0.0) + e.get("dur", 0)
        if e["cat"] == "kernel":
            kernel_us += e.get("dur", 0)
    busy = union(spans)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    hs = np.array([e["ts"] for e in host], dtype=np.float64)
    he = hs + np.array([e.get("dur", 0) for e in host], dtype=np.float64)
    idle: Dict[str, float] = {}
    for a, b in gaps[:labelled]:
        over = np.minimum(he, b) - np.maximum(hs, a) if host else np.zeros(0)
        i = int(np.argmax(over)) if over.size else -1
        label = host[i]["name"] if i >= 0 and over[i] > 0 else NO_CALL
        idle[label] = idle.get(label, 0.0) + (b - a)
    rank = lambda d: [[k, v / 1e6] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (t1 - t0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": kernel_us / 1e6, "by_op": rank(by_op),
            "idle_gaps": rank(idle)}
