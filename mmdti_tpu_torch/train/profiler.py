"""Tracing and profiling hooks (port of mmdti_tpu/train/profiler.py over
torch.profiler).

``trace(log_dir)`` records a Chrome trace of its block (host operations,
and on a CUDA device every kernel the card ran, the port's kernels under
their CUDA names); ``StepTimer`` times dispatches up to the device's
completion; ``annotate(name)`` names a region in the trace; and
``DispatchProfiler`` is the fit loop's hook: a trace of the first
``profile_steps`` dispatches of a fit into ``profile_dir``, and each
epoch's dispatch p50/p95 in the log.  Every hook is a no-op when
``profile_dir`` is unset: the timer's synchronization would otherwise
serialize the dispatches.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger("mmdti_tpu_torch")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def trace_file(log_dir: str, name: str = "trace") -> str:
    return os.path.join(log_dir, f"{name}.pt.trace.json")


def _start() -> torch.profiler.profile:
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    return prof


def _stop(prof: torch.profiler.profile, log_dir: str, name: str) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = trace_file(log_dir, name)
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace") -> Iterator[None]:
    """A Chrome trace of the block into ``log_dir`` (no-op when None)."""
    if not log_dir:
        yield
        return
    prof = _start()
    try:
        yield
    finally:
        _stop(prof, log_dir, name)


class StepTimer:
    """Wall-clock seconds per dispatch, each up to the device's completion
    of what it launched."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> None:
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"steps": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)), "p95_s": float(np.percentile(arr, 95))}


def annotate(name: str):
    """A named region in the trace (a context manager)."""
    return torch.profiler.record_function(name)


class DispatchProfiler:
    """The fit loop's hooks: a trace of the first ``profile_steps``
    dispatches of the fit's first epoch into ``profile_dir`` (as
    ``<name>.pt.trace.json``), and per-epoch dispatch p50/p95 in the log.
    Every method is a no-op when ``profile_dir`` is falsy."""

    def __init__(self, profile_dir, profile_steps: int, name: str = "trace"):
        self.dir = profile_dir
        self.steps = int(profile_steps)
        self.name = name
        self.enabled = bool(profile_dir)
        self.active = None
        self.dispatches = 0
        self.path = None
        self.timer = StepTimer() if self.enabled else None

    def begin(self, first_epoch: bool) -> None:
        if not self.enabled:
            return
        if first_epoch and self.dispatches == 0:
            self.active = _start()
        self.timer.start()

    def end(self, result) -> None:
        if not self.enabled:
            return
        self.timer.stop(result)
        self.dispatches += 1
        if self.active is not None and self.dispatches >= self.steps:
            self.close()

    def epoch_summary(self, epoch: int) -> None:
        if self.enabled and self.timer.times:
            s = self.timer.summary()
            logger.info("Epoch %d dispatch timing: p50=%.1fms p95=%.1fms over %d dispatches",
                        epoch + 1, s["p50_s"] * 1e3, s["p95_s"] * 1e3, s["steps"])
            self.timer = StepTimer()

    def close(self) -> None:
        """Stop and write a trace still open (a fit of fewer dispatches
        than profile_steps)."""
        if self.active is not None:
            prof, self.active = self.active, None
            self.path = _stop(prof, self.dir, self.name)
