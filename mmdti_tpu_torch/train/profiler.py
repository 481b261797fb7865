"""Tracing and profiling hooks (port of mmdti_tpu/train/profiler.py over
torch.profiler).

``mark(name, like)`` puts a section mark of the train step on the device:
a null kernel ``trace_mark_<name>`` (csrc/trace_mark.cu) on the current
stream of ``like``'s CUDA device, nothing on the CPU.  A mark recorded into
a CUDA graph is a node of it, so every replay emits it in stream order, and
a section of the step lasts on the device from its mark to the next one
(``MARKS`` in step order; ``mark_backward`` puts a mark where the backward
reaches a tensor).  ``span(name)`` names a region of host time in a
torch.profiler trace, on the same clock as the device's records; it is a
shared no-op while no profiler records.  ``StepTimer`` times dispatches up
to the device's completion; and ``DispatchProfiler`` is the fit loop's
hook: a Chrome trace of the first ``profile_steps`` dispatches of a fit
into ``profile_dir``, and each epoch's dispatch p50/p95 in the log.  Every
hook of the fit loop is a no-op when ``profile_dir`` is unset: the timer's
synchronization would otherwise serialize the dispatches.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from mmdti_tpu_torch.ops import _build

logger = logging.getLogger("mmdti_tpu_torch")

# the marks of one train step in the order the card meets them: the step's
# start (the row gather of a fed step), the Uni-Mol stream (gbf, embeddings,
# the encoder), the SMILES encoder, the head (InfoNCE, cross-modal fusion,
# pooling, FDS, the classification head and the losses), the backward of
# the head, of the SMILES encoder and of the Uni-Mol stream, the optimizer
# update and the step's end (after the metric sums).  A model without a
# SMILES stream (models/mof.py) emits neither smiles mark.
MARKS = ("step", "unimol", "smiles", "head", "head_bwd", "smiles_bwd", "unimol_bwd",
         "optimizer", "end")
# the marks of one train step of the docking model (models/docking.py): the
# ligand stream keeps ``unimol``; the pocket stream, the recycled decoder
# and the two distance heads (with the loss) open their own sections, and
# each has a backward mark where the backward reaches its outputs
DOCKING_MARKS = ("step", "unimol", "pocket", "decoder", "dock_head", "head_bwd",
                 "dock_head_bwd", "decoder_bwd", "pocket_bwd", "unimol_bwd", "optimizer", "end")
# a mark's index in csrc/trace_mark.cu: MARKS first, then the docking ones
_INDEX = {name: i for i, name in enumerate(
    MARKS + tuple(m for m in DOCKING_MARKS if m not in MARKS))}


def _launch(name: str, device: torch.device) -> None:
    """Launch mark ``name`` on ``device``'s current stream (a CUDA device
    only)."""
    if device.type != "cuda":
        return
    _build.check(_build.load("trace_mark").mmdti_trace_mark(
        _INDEX[name], torch._C._cuda_getCurrentRawStream(device.index)), f"trace mark {name}")


def mark(name: str, like: torch.Tensor) -> None:
    """Section mark ``name`` (one of MARKS) on the device of ``like``."""
    _launch(name, like.device)


class _BackwardMark(torch.autograd.Function):
    """The identity; its backward marks ``name`` on the stream the backward
    runs on, then passes the gradient through."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mark(ctx.name, grad)
        return grad, None


def mark_backward(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` unchanged (a view where ``x`` requires grad): mark ``name`` is
    launched as the backward reaches ``x``, once every use of ``x`` has
    passed its gradient back."""
    return _BackwardMark.apply(x, name) if x.requires_grad else x


class _JointBackwardMark(torch.autograd.Function):
    """The identity on several tensors; its backward runs once the
    gradients of all of them are in, marks ``name`` and passes them
    through (None where an output got none)."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        like = next((g for g in grads if g is not None), None)
        if like is not None:
            mark(ctx.name, like)
        return (None, *grads)


def mark_backward_joint(name: str, *xs: torch.Tensor):
    """``xs`` unchanged (views where one requires grad): mark ``name`` is
    launched once the backward has passed back the gradients of every one
    of them, the point where a section fed by all of them has finished its
    backward."""
    if not any(x.requires_grad for x in xs):
        return xs
    return _JointBackwardMark.apply(name, *xs)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named region of host time in the trace of a recording
    torch.profiler (a ``record_function`` context); one shared no-op
    context while none records."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
