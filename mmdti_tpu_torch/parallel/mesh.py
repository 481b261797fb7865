"""Data and tensor parallelism over a (data, model) mesh (port of
mmdti_tpu/parallel/mesh.py).

The JAX package jits its train step over global arrays on a ('data',
'model') mesh, so the InfoNCE and CT in-batch similarities, the task
loss's batch denominators and the FDS statistics keep global-batch
semantics, the heads and FFN widths shard over 'model' (TP_RULES,
param_sharding) and XLA inserts the collectives.  The port runs one
process per GPU under ``torch.distributed`` (NCCL on the card, gloo on
the CPU) and inserts them itself.  Process r of a ``d x m`` mesh is data
index ``r // m`` and model index ``r % m`` (the row-major layout of JAX's
``reshape(d, m)``); ``mesh_groups`` makes one subgroup per data column
and one per model row.

The data axis (``DataGroup``, over its data subgroup):

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

The model axis (``ModelGroup``): model rank r holds heads
[r H/m, (r+1) H/m) and FFN columns [r F/m, (r+1) F/m) of every transformer
layer, and the gbf projection's output heads likewise (``TP_RULES``,
written against the port's state-dict names; ``shard_state_dict`` and
``gather_state_dicts`` move between the whole tensors and a rank's
shards, exactly).  A layer is written once for both placements of a
group: one shard per process in a fit (``ProcessModelGroup``: its reduce
is an all-reduce) or the m shards of one serving replica in one process
(``ReplicaShards``: the shards run in lockstep, and a reduce sums the
partials in shard order on the first shard's device and copies the sum
back).  The layers use the Megatron conjugates: ``copy`` before a
column-parallel product (identity forward, all-reduce backward) and
``reduce`` after a row-parallel one (all-reduce forward, identity
backward); the partials are summed in fp32.  Everything else (the
embeddings, LayerNorms, InfoNCE, FDS and the heads) is replicated and
computed identically on every model rank, so its gradient is too.
Dropout draws what a one-process model draws: the model ranks of a data
row share its generator (``rank_seed(seed, data index)``), a mask over a
sharded activation is drawn whole and sliced, and the attention kernels
hash each head by its index among the layer's (ops/hopper_attention.py
``head_span``).

Under NCCL the collectives are recorded into the fit's CUDA graphs
(train/steps.py); gloo's cannot be, so a fit under a gloo group runs its
steps eagerly (on the CPU, or on CUDA tensors, which gloo takes).
``initialize_distributed`` starts the group and picks the process's card.
The JAX package's kernel-mesh registry (shard_map over Pallas calls) has
no counterpart: a CUDA kernel runs on its rank's local shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import re
import threading
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("mmdti_tpu_torch")

DATA_AXIS = "data"
MODEL_AXIS = "model"
# rank r's dropout generator starts from seed + r * this (rank 0 keeps the
# seed, so a one-rank group draws what a fit without one draws)
RANK_SEED_STRIDE = 0x9E3779B97F4A7C15
# (default group, data, model) -> (data subgroups by model index, model
# subgroups by data index): made once, by every process in one order
_SUBGROUPS: Dict[tuple, tuple] = {}
# the collective timeout initialize_distributed was given (its subgroups'
# too), or None for torch's default
_GROUP_TIMEOUT: List[Optional[datetime.timedelta]] = [None]


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
    _SUBGROUPS.clear()
    _GROUP_TIMEOUT[0] = None
    if timeout is not None:
        kwargs["timeout"] = _GROUP_TIMEOUT[0] = datetime.timedelta(seconds=float(timeout))
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
    """A (data, model) mesh: over ``devices`` (a serving mesh in one
    process: replica i's m shards are devices[i*m:(i+1)*m]), or over the
    processes of a group (no devices: each process knows its own)."""

    data: int
    model: int
    devices: Tuple[torch.device, ...] = ()

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """mesh_shape = (data, model); by default every device on the data
    axis.  ``devices`` are the devices of a serving mesh in this process
    (one may repeat: shards that share a card); without them the mesh
    spans the processes of the group (one without a group).  A shape over
    more devices than there are raises and names their count."""
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
    if d * m > count:
        hint = ("" if devices is not None else ": start one process per GPU (torchrun "
                "--nproc_per_node, or initialize_distributed in each)")
        raise ValueError(f"mesh shape {(d, m)} needs {d * m} {what}; only {count} "
                         f"available{hint}")
    return Mesh(d, m, tuple(devices[:d * m]) if devices is not None else ())


class DataGroup:
    """The data axis of a training mesh: this process is rank ``rank`` (its
    data index) of the ``size`` processes of ``group`` (its data subgroup;
    None: the default group, a mesh with model 1).  ``recordable``: its
    collectives can be recorded into a CUDA graph (NCCL).  Gloo takes CUDA
    tensors as they are (a gloo group of processes on the card)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()
        self.recordable = self.backend == "nccl"
        # the global rank of this group's rank 0 (a broadcast's source)
        self._src = 0 if group is None else dist.get_global_rank(group, 0)
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
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=self.group)
            return t
        dist.all_reduce(t, group=self.group)
        return t.div_(self.size)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Copy rank 0's values of ``tensors`` into every rank's, in place."""
        for t in tensors:
            self.calls += 1
            dist.broadcast(t, self._src, group=self.group)

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def _reduce_scatter_sum(self, g: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        out = g.new_empty((g.shape[0] // self.size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=self.group)
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


# ---- the model axis -----------------------------------------------------------

# The twin of the JAX package's TP_RULES over the port's state-dict names:
# name pattern -> how the tensor splits over the model ranks.  "rows": the
# output features of a column-parallel product (its weight's rows and its
# bias); "cols": the input features of a row-parallel product (its weight's
# columns; its bias stays whole, added once after the reduce); "qkv": the
# fused [3E, E] in_proj, per head from each of its q, k and v thirds (a
# contiguous split would give rank 0 all of q and half of k).  Every other
# tensor is replicated.
TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"encoder\.layers_\d+\.in_proj\.(weight|bias)", "qkv"),
    (r"encoder\.layers_\d+\.fc1\.(weight|bias)", "rows"),
    (r"encoder\.layers_\d+\.(out_proj|fc2)\.weight", "cols"),
    (r"bert\.layer_\d+\.(attn_query|attn_key|attn_value|intermediate)\.(weight|bias)", "rows"),
    (r"bert\.layer_\d+\.(attn_output|output)\.weight", "cols"),
    (r"cross_modal_module\.(graph|text)_attention\.layer_\d+\."
     r"(query|key|value|intermediate)\.(weight|bias)", "rows"),
    (r"cross_modal_module\.(graph|text)_attention\.layer_\d+\.(attn_output|output)\.weight",
     "cols"),
    (r"gbf_proj\.linear2\.(weight|bias)", "rows"),
)
_TP_COMPILED = tuple((re.compile(pat), kind) for pat, kind in TP_RULES)


def tp_rule(name: str) -> Optional[str]:
    """How the tensor ``name`` splits over the model ranks ("rows", "cols"
    or "qkv"), or None when it is replicated."""
    for pat, kind in _TP_COMPILED:
        if pat.fullmatch(name):
            return kind
    return None


def _split_view(kind: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(the tensor as it splits, the dim it splits on): in_proj as [3, E, E]
    split on its heads' dim, a "cols" tensor on dim 1, a "rows" one on 0."""
    if kind == "qkv":
        return t.reshape(3, t.shape[0] // 3, *t.shape[1:]), 1
    return t, 1 if kind == "cols" else 0


def shard_tensor(name: str, t: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Model rank ``index``'s shard of the whole tensor ``name`` (a copy,
    contiguous); a replicated tensor as it is."""
    kind = tp_rule(name)
    if kind is None or size == 1:
        return t
    view, dim = _split_view(kind, t)
    n = view.shape[dim]
    if n % size:
        raise ValueError(f"{name} {tuple(t.shape)}: {n} do not split {size} ways")
    part = view.narrow(dim, index * n // size, n // size)
    return (part.reshape(-1, *t.shape[1:]) if kind == "qkv" else part).contiguous()


def gather_tensor(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor ``name`` from its shards in model-rank order (the
    inverse of shard_tensor, exact); a replicated tensor is shard 0's."""
    kind = tp_rule(name)
    if kind is None or len(shards) == 1:
        return shards[0]
    views = [_split_view(kind, x) for x in shards]
    whole = torch.cat([v for v, _ in views], dim=views[0][1])
    return whole.reshape(-1, *shards[0].shape[1:]) if kind == "qkv" else whole


def full_shape(name: str, shape: Sequence[int], size: int) -> Tuple[int, ...]:
    """The whole tensor's shape from a shard's."""
    shape = tuple(int(x) for x in shape)
    kind = tp_rule(name)
    if kind is None:
        return shape
    dim = 1 if kind == "cols" else 0
    return shape[:dim] + (shape[dim] * size,) + shape[dim + 1:]


def shard_state_dict(sd: Mapping[str, torch.Tensor], index: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s state dict of ``size`` from the whole one (the
    twin of the JAX package's param_sharding)."""
    return {k: shard_tensor(k, v, index, size) for k, v in sd.items()}


def gather_state_dicts(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's, in rank order."""
    return {k: gather_tensor(k, [sd[k] for sd in shards]) for k in shards[0]}


def check_divisible(what: str, n: int, size: int) -> None:
    """Tensor parallelism over ``size`` model ranks splits ``what`` (n of
    them) evenly, or raises ValueError naming it."""
    if n % size:
        raise ValueError(f"tensor parallelism over {size} model ranks: {what} = {n} is not "
                         f"divisible by {size}")


class ModelGroup:
    """The model axis of a (data, model) mesh as a layer sees it: its shard
    ``index`` of ``size``, and the two raw collectives a subclass provides,
    ``_all_reduce`` (the fp32 sum of every shard's tensor) and
    ``_all_gather`` (every shard's tensor, concatenated in shard order
    along a dim).  ``recordable``: its collectives can be recorded into a
    CUDA graph.  ``calls`` counts the collectives issued."""

    index: int = 0
    size: int = 1
    recordable: bool = True

    def __init__(self):
        self.calls = 0

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def span(self, n: int) -> Tuple[int, int]:
        """(start, stop) of this shard's part of ``n`` heads or columns."""
        return self.index * n // self.size, (self.index + 1) * n // self.size

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the fp32 sum of every shard's
        partial ``x``, differentiable (its backward is the identity)."""
        return _Reduce.apply(self, x)

    def copy(self, *xs: torch.Tensor):
        """Before a column-parallel product: ``xs`` as they are, whose
        gradients are summed over the shards in the backward (one packed
        fp32 all-reduce).  A tensor, or a tuple of them for several."""
        out = _Copy.apply(self, *xs)
        return out[0] if len(xs) == 1 else out

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``x`` concatenated along ``dim`` (the heads of a
        [B, H/m, N, N] tensor), differentiable: the backward keeps this
        shard's slice of the cotangent."""
        return _Gather.apply(self, x, dim)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: ModelGroup, x):
        return group._all_reduce(x.float())

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: ModelGroup, *xs):
        ctx.group = group
        ctx.metas = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = [torch.zeros(shape, dtype=torch.float32, device=_device_of(gs))
                if g is None else g.float() for g, (shape, _) in zip(gs, ctx.metas)]
        total = ctx.group._all_reduce(torch.cat([g.reshape(-1) for g in flat]))
        out, off = [], 0
        for shape, dtype in ctx.metas:
            n = shape.numel()
            out.append(total[off:off + n].view(shape).to(dtype))
            off += n
        return (None, *out)


def _device_of(gs):
    return next(g.device for g in gs if g is not None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: ModelGroup, x, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group._all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.group.index * ctx.n
        return None, g.narrow(ctx.dim, start, ctx.n).contiguous(), None


class ProcessModelGroup(ModelGroup):
    """The model axis of a fit: one shard a process, over the
    torch.distributed subgroup ``group`` of this process's model row; this
    process is shard ``index`` of ``size``."""

    def __init__(self, group, index: int, size: int):
        super().__init__()
        self.group, self.index, self.size = group, int(index), int(size)
        self.backend = str(dist.get_backend(group)).lower()
        self.recordable = self.backend == "nccl"

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        t = t.contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self.calls += 1
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def gather_state_dict(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole state dict from every shard's ``sd`` (CPU tensors out),
        on every shard: a collective."""
        mine = {k: v.detach().cpu() for k, v in sd.items() if tp_rule(k) is not None}
        every = [None] * self.size
        self.calls += 1
        dist.all_gather_object(every, mine, group=self.group)
        out = {}
        for k, v in sd.items():
            out[k] = (v.detach().cpu() if tp_rule(k) is None
                      else gather_tensor(k, [shard[k] for shard in every]))
        return out


class _PeerFailed(RuntimeError):
    """Raised in a shard whose peer shard failed (the peer's error is the
    one ReplicaShards.run raises)."""


class ReplicaShards:
    """The m shards of one serving replica, in one process: shard i on
    ``devices[i]`` (a device may repeat).  ``handle(i)`` is shard i's
    ModelGroup; ``run(fns)`` runs ``fns[i]()`` as shard i, each in a thread
    of its own, in lockstep: one shard runs at a time, in shard order from
    one collective to the next.  A collective's last shard sums (or
    concatenates) the partials in shard order on ``devices[0]`` and each
    shard takes its copy on its own device.

    Shards that share one card run one after another on the caller's
    current stream, so a CUDA graph captured around ``run`` records all of
    them and the reductions between them; shards on several cards run on
    each card's current stream, eagerly (a graph records one device).  The
    group serves: ``run`` raises when autograd is on."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self._cv = threading.Condition()
        self._turn: Optional[int] = None
        self._slots: List[Optional[torch.Tensor]] = [None] * self.size
        self._results: List[Optional[torch.Tensor]] = [None] * self.size
        self._error: Optional[BaseException] = None
        self._handles = [_ShardHandle(self, i) for i in range(self.size)]

    @property
    def one_device(self) -> bool:
        return len(set(self.devices)) == 1

    def handle(self, index: int) -> "ModelGroup":
        return self._handles[index]

    def run(self, fns: Sequence[Callable[[], object]]) -> list:
        """Every shard's ``fns[i]()``, in lockstep; returns their results in
        shard order, or raises the first shard's error."""
        if torch.is_grad_enabled():
            raise RuntimeError("a replica's shards serve: run them under torch.no_grad()")
        if len(fns) != self.size:
            raise ValueError(f"{len(fns)} functions for {self.size} shards")
        streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in self.devices]
        inference = torch.is_inference_mode_enabled()
        out: List[object] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size
        with self._cv:
            self._turn, self._error = 0, None
            self._slots = [None] * self.size

        def body(i):
            try:
                mode = torch.inference_mode() if inference else contextlib.nullcontext()
                with mode, torch.no_grad(), _on_stream(self.devices[i], streams[i]):
                    self._wait_turn(i)
                    out[i] = fns[i]()
            except BaseException as e:  # handed to the caller below
                errors[i] = e
                with self._cv:
                    self._error = self._error or e
                    self._cv.notify_all()
                return
            self._pass(i + 1 if i + 1 < self.size else None)

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"mmdti-shard-{i}") for i in range(1, self.size)]
        for t in threads:
            t.start()
        body(0)
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None and not isinstance(e, _PeerFailed)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return out

    def _wait_turn(self, i: int) -> None:
        with self._cv:
            while self._turn != i and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise _PeerFailed("a peer shard failed")

    def _pass(self, nxt: Optional[int]) -> None:
        with self._cv:
            self._turn = nxt
            self._cv.notify_all()

    def _collective(self, i: int, x: torch.Tensor, combine) -> torch.Tensor:
        self._slots[i] = x
        if i + 1 < self.size:
            self._pass(i + 1)
        else:
            if any(s is None for s in self._slots):
                raise RuntimeError("the shards of a replica issued different collectives")
            whole = combine([s.to(self.devices[0]) for s in self._slots])
            self._results = [whole if d == self.devices[0] else whole.to(d)
                             for d in self.devices]
            self._slots = [None] * self.size
            self._pass(0)
        self._wait_turn(i)
        return self._results[i]


class _ShardHandle(ModelGroup):
    """Shard ``index`` of a ReplicaShards, as its layers see it (its
    collectives are not counted: no graph of a fit holds them)."""

    def __init__(self, shards: ReplicaShards, index: int):
        super().__init__()
        self.shards, self.index, self.size = shards, index, shards.size

    @property
    def recordable(self) -> bool:
        return self.shards.one_device

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        def total(parts):
            acc = parts[0].float().clone()
            for p in parts[1:]:
                acc += p.float()
            return acc
        return self.shards._collective(self.index, t, total)

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self.shards._collective(self.index, t, lambda parts: torch.cat(parts, dim=dim))


class _on_stream:
    """Make ``device`` and ``stream`` current in this thread for the block,
    and restore the thread's device and stream after it (nothing for the
    CPU)."""

    def __init__(self, device: torch.device, stream):
        self.device, self.stream, self._ctxs = device, stream, []

    def __enter__(self):
        if self.device.type == "cuda":
            self._ctxs = [torch.cuda.device(self.device), torch.cuda.stream(self.stream)]
            for c in self._ctxs:
                c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in reversed(self._ctxs):
            c.__exit__(*exc)
        return False


def mesh_groups(mesh: Mesh) -> Tuple[DataGroup, Optional[ProcessModelGroup]]:
    """This process's data group and model group (None when model is 1)
    on ``mesh``, over the processes of the default group: rank r is data
    index r // m and model index r % m.  The subgroups are made once, by
    every process in the same order (torch.distributed.new_group is a
    collective of the default group)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    d, m = mesh.data, mesh.model
    if d * m != world:
        raise ValueError(f"mesh shape {(d, m)}: a fit's mesh is its {world} processes, one per "
                         f"GPU (data x model = {world})")
    if m == 1:
        return DataGroup(), None
    key = (id(dist.distributed_c10d._get_default_group()), d, m)
    if key not in _SUBGROUPS:
        kw = {} if _GROUP_TIMEOUT[0] is None else {"timeout": _GROUP_TIMEOUT[0]}
        columns = [dist.new_group([i * m + j for i in range(d)], **kw) for j in range(m)]
        rows = [dist.new_group([i * m + j for j in range(m)], **kw) for i in range(d)]
        _SUBGROUPS[key] = (columns, rows)
    columns, rows = _SUBGROUPS[key]
    return DataGroup(columns[rank % m]), ProcessModelGroup(rows[rank // m], rank % m, m)


def model_state(model: torch.nn.Module,
                sd: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole state dict of ``model`` (or of ``sd``, a state dict of its
    shapes): its own without a model group, else gathered over its
    ProcessModelGroup (a collective: every model rank calls it)."""
    sd = model.state_dict() if sd is None else sd
    group = getattr(model, "model_group", None)
    if group is None or group.size == 1:
        return dict(sd)
    return group.gather_state_dict(sd)


def model_shard(model: torch.nn.Module,
                sd: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """The part of the whole state dict ``sd`` that ``model`` holds: all of
    it, or its model rank's shard."""
    group = getattr(model, "model_group", None)
    if group is not None and group.size > 1:
        return shard_state_dict(sd, group.index, group.size)
    return sd


def load_model_state(model: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                     strict: bool = True):
    """Load the whole state dict ``sd`` into ``model``: as it is, or this
    model rank's shard of it."""
    return model.load_state_dict(model_shard(model, sd), strict=strict)
