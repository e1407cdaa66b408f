"""The profiled sub-window of a traced run, read from ``torch.profiler``.

After the measured window, ``trace_calls`` more calls of the cell run
under ``torch.profiler`` (CPU and CUDA activity).  The trace is exported as
Chrome JSON under a fresh directory in the run's ``TMPDIR``, read back and
deleted.  What the metric readers get: every device interval (kernels,
copies, fills) inside the sub-window, the host's events, the sub-window's
length, and the device's busy time (the union of the intervals).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
CALL = "perfbench.call"
TOP = 10            # entries of each list of the breakdown
NAME_CHARS = 160    # a kernel's demangled name, cut to this length


class Trace:
    """Device intervals ``(name, start_us, end_us)`` and host events
    ``(name, start_us, end_us)`` of the sub-window ``[t0_us, t1_us]``."""

    def __init__(self, device, host, t0_us, t1_us, calls, wall_s):
        self.device = device
        self.host = host
        self.t0_us, self.t1_us = t0_us, t1_us
        self.calls = calls
        self.wall_s = wall_s
        self.window_s = (t1_us - t0_us) / 1e6
        self.busy_s = union_us(device) / 1e6

    def device_time_s(self, match) -> tuple:
        """``(seconds, launches)`` of the device intervals whose name
        ``match`` accepts."""
        hits = [e for e in self.device if match(e[0])]
        return sum(e[2] - e[1] for e in hits) / 1e6, len(hits)

    def gaps(self) -> list:
        """Idle stretches of the device inside the sub-window, as
        ``(start_us, end_us)``."""
        out, at = [], self.t0_us
        for s, e in merged(self.device):
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1_us > at:
            out.append((at, self.t1_us))
        return out

    def host_at(self, t_us: float) -> str:
        """The innermost host event running at ``t_us``."""
        best = None
        for name, s, e in self.host:
            if s <= t_us <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "host: no traced event"

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, s, e in self.device:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}


def merged(intervals) -> list:
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def profile(cell, calls: int, device) -> Trace:
    """Run ``calls`` calls of ``cell`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t = time.perf_counter()
        with record_function("perfbench.window"):
            for _ in range(calls):
                with record_function(CALL):
                    cell.call()
            if device.type == "cuda":
                torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return read_events(events, calls, wall_s)


def read_events(events, calls, wall_s) -> Trace:
    """A :class:`Trace` from Chrome trace events: the sub-window is the
    ``perfbench.window`` annotation; device intervals are clipped to it."""
    win = [e for e in events if e.get("name") == "perfbench.window"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace holds no perfbench.window span")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, end = max(s, t0), min(end, t1)
            if end > s:
                device.append((e["name"], s, end))
        elif cat in HOST_CATS and e["name"] != "perfbench.window":
            host.append((e["name"], s, end))
    return Trace(device, host, t0, t1, calls, wall_s)
