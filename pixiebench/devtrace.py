"""What a ``torch.profiler`` trace of the profiled stretch says.

The sums by device operation are ``chip_smoke.trace_summary``'s
arithmetic, frozen: the chrome trace kineto writes, each kernel, copy and
set summed by name.  Beside them: the seconds in which any device
operation ran (the union of their intervals, so overlapping operations
count once), and each idle gap between device operations charged to what
the host was doing then: the innermost host operation open at the gap's
middle, or ``python`` where none was.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10            # entries of each breakdown list
INNERMOST_SCAN = 64  # host operations looked back through for a gap's owner


class Summary(NamedTuple):
    device_ops: Dict[str, List[float]]  # name -> [count, microseconds]
    busy_s: float
    n_device_ops: int
    idle_gaps: List[Tuple[str, float]]  # (host activity, seconds), longest first


def events_of(prof) -> list:
    """The profile's chrome-trace events (written to a temporary file)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def summarize(events: list) -> Summary:
    device = collections.defaultdict(lambda: [0, 0.0])
    spans, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            d = device[e["name"]]
            d[0] += 1
            d[1] += e["dur"]
            spans.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in HOST_CATS:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    host.sort()
    starts = [h[0] for h in host]
    gaps = collections.defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = (end + nxt) / 2
        owner = "python"
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        for j in range(i, max(-1, i - INNERMOST_SCAN), -1):
            s, t, name = host[j]
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
        if best is not None:
            owner = best[1]
        gaps[owner] += (nxt - end) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return Summary(dict(device), busy_us / 1e6, len(spans), idle)


def breakdown(summary: Summary) -> dict:
    """The ``--trace 1`` line's ``breakdown``: the device operations that
    took the most time and the idle seconds by host activity, as measured."""
    ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1][1])
    return {"device_ops": [[name[:120], us / 1e6] for name, (_, us) in ops[:TOP]],
            "idle_gaps": [[name[:120], s] for name, s in summary.idle_gaps[:TOP]]}


def kernel_seconds(summary: Summary, kernel: str) -> float:
    """Device seconds of the kernel whose function is named ``kernel``, its
    name demangled (``void ns::k<...>(...)``, ``(anonymous namespace)::``
    included) or mangled (``_Z<len>k...``)."""
    mangled = f"_Z{len(kernel)}{kernel}"
    total = 0.0
    for name, (_, us) in summary.device_ops.items():
        bare = name.replace("(anonymous namespace)::", "")
        head = bare.split("(")[0].split("<")[0].split()
        if (head and head[-1].split("::")[-1] == kernel) or name.startswith(mangled):
            total += us
    return total / 1e6
