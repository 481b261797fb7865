"""Device trace of a traced window: torch.profiler's CUDA activity, read
from its Chrome trace.

The trace holds every kernel, copy and set on the device with its start
and duration, including the kernels of replayed CUDA graphs, and the
host's operations.  ``Trace`` gives the device intervals, the busy time
(the union of the intervals), the window (first device start to last
device end), the top operations by time and the longest idle gaps named
by what the host was doing meanwhile.

The tracer can lose events at a window's end, so spin kernels
(torch.cuda._sleep) stand before and after the traced work, the profiler
stays open 20 ms after them, and the spin kernels are left out.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")
SPIN = "spin_kernel"


class Trace:
    def __init__(self, events: List[dict]):
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
               and SPIN not in e.get("name", "")]
        self.device = sorted(((float(e["ts"]), float(e.get("dur", 0.0)), e["name"]) for e in dev),
                             key=lambda x: x[0])
        self.host = sorted(((float(e["ts"]), float(e.get("dur", 0.0)), e["name"]) for e in events
                            if e.get("cat") in HOST_CATS and e.get("ph") == "X"),
                           key=lambda x: x[0])

    def kernels(self, *parts: str) -> List[Tuple[float, float, str]]:
        """Device events whose name contains any of ``parts``."""
        return [e for e in self.device if any(p in e[2] for p in parts)]

    @property
    def window_s(self) -> float:
        if not self.device:
            return 0.0
        return (max(t + d for t, d, _ in self.device) - self.device[0][0]) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for t, d, _ in self.device:
            if out and t <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t + d)
            else:
                out.append([t, t + d])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def device_sum_s(self) -> float:
        return sum(d for _, d, _ in self.device) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: dict = {}
        for _, d, name in self.device:
            by[name] = by.get(name, 0.0) + d / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between device intervals, each named by the
        host operation that began last before the gap's middle and was
        still running there ("host: none" when there was none)."""
        spans = self._merged()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            name = "host: none"
            for t, d, nm in self.host:
                if t > mid:
                    break
                if t + d >= mid:
                    name = nm
            out.append([name[:120], (g1 - g0) / 1e6])
        return out


def traced(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` under torch.profiler (CPU and CUDA activity) between spin
    kernels and return its Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        fn()
        for _ in range(3):
            torch.cuda._sleep(1000)
        sync()
        time.sleep(0.02)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
