"""Data parallelism over processes, and the (data, model) mesh record (port
of mmdti_tpu/parallel/mesh.py).

The JAX package jits its train step over global arrays on a ('data',
'model') mesh, so the InfoNCE and CT in-batch similarities, the task
loss's batch denominators and the FDS statistics keep global-batch
semantics and XLA inserts the collectives.  The port runs one process per
GPU under ``torch.distributed`` (NCCL on the card, gloo on the CPU) and
inserts them itself (``DataGroup``):

* every rank holds the whole global batch's labels and weights and runs
  the forward on its own rows (``local_rows``);
* the loss is computed on the rows every rank gathers (``gather_rows``,
  differentiable), identically on every rank;
* the flat gradient is averaged over the ranks once a step (``average_``).

Each rank computes the same global loss L, so the gather's backward (the
sum over ranks of every rank's cotangent of a rank's rows) hands each
rank W * dL/dx for its rows x, its parameter gradient is W times its
rows' share of dL/dtheta, and the average over the W ranks is exactly
dL/dtheta: the update of a one-process fit on the whole batch.

Under NCCL the collectives are recorded into the fit's CUDA graphs
(train/steps.py); gloo's cannot be, so a fit under a gloo group runs its
steps eagerly (on the CPU, or on CUDA tensors, which gloo takes).  A
process's mesh position is its rank; ``initialize_distributed`` starts
the group and picks the process's card.

The JAX package's kernel-mesh registry (shard_map over Pallas calls) has
no counterpart: a CUDA kernel runs on its rank's local shapes.  Tensor
parallelism (``TP_RULES``, ``param_sharding``: a mesh with ``model > 1``)
is not ported yet and raises (ROADMAP.md §1, tensor parallelism).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("mmdti_tpu_torch")

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_NOT_PORTED = ("a mesh with model > 1 is tensor parallelism (the JAX package's TP_RULES and "
                 "param_sharding), which is not ported yet (ROADMAP.md §1, tensor parallelism)")
# rank r's dropout generator starts from seed + r * this (rank 0 keeps the
# seed, so a one-rank group draws what a fit without one draws)
RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Start this process's torch.distributed group and return its device.

    Without arguments the group reads torchrun's environment (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); with
    ``coordinator_address`` ("host:port", or a URL such as
    ``file:///path``, a rendezvous file that needs no free port) it meets
    the other ``num_processes`` processes, this one as ``process_id``.
    The backend is NCCL when CUDA is available and gloo otherwise
    (``backend`` names another).  ``timeout`` (seconds) bounds the
    rendezvous and every collective's wait, so a process whose peer died
    raises instead of waiting for torch's default.  Each process takes
    ``cuda:{LOCAL_RANK}`` (torchrun sets it; without it, the rank modulo
    the visible cards)."""
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    else:
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    device = torch.device("cpu")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    if torch.cuda.is_available():
        device = local_device(rank)
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    logger.info("process %d of %d joined the %s group on %s", rank, world, backend, device)
    return device


def local_device(rank: Optional[int] = None) -> torch.device:
    """``cuda:{LOCAL_RANK}``, or without LOCAL_RANK the rank modulo the
    visible cards."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def is_writer_process() -> bool:
    """The single-writer rule: every process runs the same fit against one
    experiment dir, and only rank 0 (or a process outside any group)
    writes it."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every process of the group (nothing without one): what
    rank 0 wrote is there for the others to read after it."""
    if dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh: over ``devices`` (the replicas of a serving
    mesh in one process), or over the processes of a group (no devices:
    each process knows its own)."""

    data: int
    model: int
    devices: Tuple[torch.device, ...] = ()

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """mesh_shape = (data, model); by default every device on the data
    axis.  ``devices`` are the devices of a serving mesh in this process;
    without them the mesh spans the processes of the group (one without a
    group).  A shape over more devices than there are raises and names
    their count; ``model > 1`` raises (tensor parallelism is not ported)."""
    if devices is None:
        count, what = (dist.get_world_size() if dist.is_initialized() else 1), "processes"
    else:
        devices = [torch.device(x) for x in devices]
        count, what = len(devices), "devices"
    if mesh_shape is None:
        mesh_shape = (count, 1)
    d, m = (int(x) for x in mesh_shape)
    if d < 1 or m < 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} must be positive")
    if m > 1:
        raise NotImplementedError(f"mesh shape {(d, m)}: {TP_NOT_PORTED}")
    if d * m > count:
        hint = ("" if devices is not None else ": start one process per GPU (torchrun "
                "--nproc_per_node, or initialize_distributed in each)")
        raise ValueError(f"mesh shape {(d, m)} needs {d * m} {what}; only {count} "
                         f"available{hint}")
    return Mesh(d, m, tuple(devices[:d * m]) if devices is not None else ())


class DataGroup:
    """The data axis of a training mesh: this process is rank ``rank`` of
    the ``size`` processes of the default group.  ``recordable``: its
    collectives can be recorded into a CUDA graph (NCCL).  Gloo takes CUDA
    tensors as they are (a gloo group of processes on the card)."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend()).lower()
        self.recordable = self.backend == "nccl"
        # collectives issued, for a caller that counts what a step or a
        # graph holds
        self.calls = 0

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch: the r-th of ``size`` equal
        slices of the leading axis."""
        b = x.shape[0] // self.size
        return x[self.rank * b:(self.rank + 1) * b]

    def gather_rows(self, *xs: torch.Tensor):
        """Every rank's rows of each of ``xs`` (tensors of this rank's B
        rows), in rank order, on every rank, in one collective: a tensor,
        or a tuple of them for several.  The gradient flows back to each
        rank's own rows.  Every tensor out, and every gradient back, is a
        contiguous tensor of its own, so a one-rank group computes what no
        group computes, bit for bit."""
        out = _GatherRows.apply(self, *xs)
        return out[0] if len(xs) == 1 else out

    def average_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its mean over the ranks (NCCL's
        average; gloo's sum, then divided)."""
        self.calls += 1
        if self.backend == "nccl":
            dist.all_reduce(t, op=dist.ReduceOp.AVG)
            return t
        dist.all_reduce(t)
        return t.div_(self.size)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Copy rank 0's values of ``tensors`` into every rank's, in place."""
        for t in tensors:
            self.calls += 1
            dist.broadcast(t, 0)

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out

    def _reduce_scatter_sum(self, g: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        out = g.new_empty((g.shape[0] // self.size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM)
        return out


class _GatherRows(torch.autograd.Function):
    """Forward: the tensors packed side by side into one [B, F] buffer and
    all-gathered along the rows.  Backward: the cotangents packed the same
    way; each rank's rows receive the sum over ranks of theirs (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, group: DataGroup, *xs):
        ctx.group = group
        ctx.shapes = [x.shape for x in xs]
        packed = torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)
        return _unpack(group._all_gather(packed), ctx.shapes, group.size)

    @staticmethod
    def backward(ctx, *gs):
        packed = torch.cat([g.reshape(g.shape[0], -1) for g in gs], dim=1)
        return (None, *_unpack(ctx.group._reduce_scatter_sum(packed.contiguous()),
                               ctx.shapes, 1))


def _unpack(packed: torch.Tensor, shapes, rows_factor: int):
    """The columns of ``packed`` back into tensors of ``shapes`` (rows times
    ``rows_factor``), each contiguous."""
    out, col = [], 0
    for shape in shapes:
        width = shape[1:].numel()
        part = packed[:, col:col + width].contiguous()
        out.append(part.view(shape[0] * rows_factor, *shape[1:]))
        col += width
    return tuple(out)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout generator: rank 0 keeps
    ``seed``; the others start streams of their own, so no two ranks draw
    the same masks for their rows."""
    return (int(seed) + int(rank) * RANK_SEED_STRIDE) % (1 << 63)
