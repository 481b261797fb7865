"""The train steps and the eval steps (port of
mmdti_tpu/train/steps.py::StepBuilderMixin: build_train_step's single, K
stacked and K fed variants, build_eval_step and build_eval_sweep).

A train step runs the model forward with dropout on, takes
``alpha * task + beta * InfoNCE + beta * CT`` as its loss, differentiates it
(on the kernel path through the hand-written backward kernels) and hands
the gradients to the clip + Adam + apply of train/optim.py.  An eval step
runs the deterministic forward and a batch loss that ignores padded
trailing rows exactly.

Where the JAX package compiles K steps into one ``lax.scan`` program, the
port records them into one CUDA graph (``capture_graph``) and replays it:
the host issues one graph launch for K steps instead of ~4,250 kernels a
step.  A graph replays the kernels it recorded on the tensors it recorded,
so everything that changes between replays lives in tensors that stay
where they are: the parameters and the optimizer's buffers and counts
(train/optim.py), the index block or the stacked batches, the epoch, the
FDS state and the valid-row count, all written in place.  On the CPU the
same functions run their steps one by one.

Under data parallelism (a ``data_group``, parallel/mesh.py) a train step
runs the forward on this rank's rows of the global batch, gathers the
rows every loss term reads (the logits and the pooled features; InfoNCE
gathers its two projections in the model) and computes the loss of the
whole global batch, the same on every rank; the optimizer averages the
gradient over the ranks.  Under NCCL those collectives are recorded into
the K-step CUDA graphs with everything else; under gloo, whose
collectives cannot be recorded, the K variants run their steps eagerly.
Under tensor parallelism (the optimizer's ``model_group``) the model's
own collectives (parallel/mesh.py ModelGroup) sit in the same graphs
under NCCL, and a gloo model group runs the steps eagerly likewise.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Mapping, Optional

import torch

from mmdti_tpu_torch.losses.contrastive import CT_REGISTRY
from mmdti_tpu_torch.ops.hopper_ln import ln_kernels_on
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.profiler import mark, span

logger = logging.getLogger("mmdti_tpu_torch")

# a train step's metrics: its losses and the global norm of its gradients
# (before the clip), which debug_nans reads
METRICS = ("loss", "m_loss", "infonce_loss", "ct_loss", "grad_norm")
GRAPH_WARMUP = 2   # eager runs on a side stream before a capture


def build_train_loss(loss_fn: Callable, task: str, use_infonce: bool = True,
                     use_ct: bool = True, use_weight: bool = True, alpha: float = 1.0,
                     beta: float = 0.1, ct_w: float = 0.2, data_group=None):
    """``train_loss(model, feats, labels, weights, generator, **model_kw) ->
    (total, metrics)``: the forward (dropout on when ``generator`` is given;
    ``model_kw`` go to the model, e.g. the FDS state) and
    ``alpha * task + beta * InfoNCE + beta * CT``.  The metrics are 0-dim
    tensors (loss, m_loss, infonce_loss, ct_loss) left on the device.

    With a ``data_group`` (parallel/mesh.py DataGroup) ``feats`` hold this
    rank's rows and ``labels`` and ``weights`` the whole global batch's:
    the logits and pooled features of every rank are gathered (and InfoNCE
    gathers its projections, ``gather_rows``), so every term is the global
    batch's, as one process computes it on the whole batch.  Averaging the
    ranks' local losses instead would be wrong wherever a denominator or
    a pair depends on the batch: the NaN-masked multilabel losses, focal
    and GHM's bin counts, CT's in-batch pairs, InfoNCE's negatives."""
    ct_fn = CT_REGISTRY.get(task) if use_ct else None
    model_gather = {} if data_group is None else {"gather_rows": data_group.gather_rows}

    def train_loss(model, feats: Mapping[str, torch.Tensor], labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, **model_kw):
        out = model(**feats, outputs="train", deterministic=generator is None,
                    generator=generator, **model_gather, **model_kw)
        logits, pooled = out["logits"], out["pooled"]
        if data_group is not None:
            logits, pooled = data_group.gather_rows(logits, pooled)
        task_loss = loss_fn(logits, labels)
        total = alpha * task_loss
        infonce = out["infonce_loss"]
        if use_infonce:
            total = total + beta * infonce
        if ct_fn is not None:
            ct = ct_fn(pooled, labels, logits, weights=weights if use_weight else None, w=ct_w)
            total = total + beta * ct
        else:
            ct = torch.zeros((), device=total.device)
        return total, {"loss": total.detach(), "m_loss": task_loss.detach(),
                       "infonce_loss": infonce.detach(), "ct_loss": ct.detach()}

    return train_loss


def build_train_step(model, optimizer: FusedAdam, loss_fn: Callable, task: str, **loss_kw):
    """``train_step(feats, labels, weights, generator) -> metrics``: the
    loss of build_train_loss (``loss_kw`` are its options), its gradients
    with respect to those of ``optimizer.params`` that require grad (a
    frozen parameter gets None, which the update counts as zero), and one
    optimizer update; the metrics add the gradients' global norm as
    "grad_norm".  Under data parallelism (``loss_kw["data_group"]``, the
    optimizer's too) ``feats`` are this rank's rows and ``labels`` and
    ``weights`` the global batch's (build_train_loss).

    ``feats`` holds the model's input tensors (train/device_feed.py
    FEATURE_KEYS); ``generator`` (a torch.Generator on their device) draws
    every dropout mask of the step, and None runs the step without
    dropout; ``model_kw`` go to the model (the FDS state, net_target, epoch
    and buckets of the fit loop)."""
    train_loss = build_train_loss(loss_fn, task, **loss_kw)
    names = [n for n, p in optimizer.params.items() if p.requires_grad]
    params = [optimizer.params[n] for n in names]

    def train_step(feats: Mapping[str, torch.Tensor], labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   **model_kw) -> Dict[str, torch.Tensor]:
        total, metrics = train_loss(model, feats, labels, weights, generator, **model_kw)
        mark("head_bwd", total)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        mark("optimizer", total)
        metrics["grad_norm"] = optimizer.apply(dict(zip(names, grads)))
        return metrics

    return train_step


def make_batch_loss(loss_fn: Callable):
    """Batch loss over the first ``valid_n`` rows only (an int, or an
    integer tensor on the logits' device, as the eval sweep's graph reads
    it): padded trailing rows repeat the last sample and must not bias the
    loss.  A NaN-maskable loss excludes them by NaN labels; any other is
    averaged per row (exact for row-decomposable means: mse, ce, bce)."""
    if getattr(loss_fn, "nan_maskable", False):
        def batch_loss(logits, labels, valid_n):
            keep = torch.arange(logits.shape[0], device=logits.device) < valid_n
            keep = keep.reshape((-1,) + (1,) * (labels.dim() - 1))
            return loss_fn(logits, torch.where(keep, labels.float(),
                                               torch.full_like(labels.float(), float("nan"))))
    else:
        def batch_loss(logits, labels, valid_n):
            per_row = torch.stack([loss_fn(logits[i:i + 1], labels[i:i + 1])
                                   for i in range(logits.shape[0])])
            keep = (torch.arange(logits.shape[0], device=logits.device) < valid_n).float()
            n = torch.as_tensor(valid_n, dtype=torch.float32, device=logits.device)
            return torch.sum(per_row * keep) / n.clamp_min(1.0)
    return batch_loss


def build_eval_step(model, loss_fn: Callable, activation_fn: Callable, alpha: float = 1.0):
    """``eval_step(feats, labels, valid_n) -> (preds, loss, pooled,
    cls_repr)`` on the deterministic forward."""
    batch_loss = make_batch_loss(loss_fn)

    @torch.no_grad()
    def eval_step(feats, labels, valid_n):
        out = model(**feats, outputs="train")
        loss = alpha * batch_loss(out["logits"], labels, valid_n)
        return activation_fn(out["logits"]), loss, out["pooled"], out["cls_repr"]

    return eval_step


# ---- resident data and graphs ---------------------------------------------------

@dataclasses.dataclass
class Resident:
    """A dataset collated once and kept on the device
    (train/device_feed.py): the model's input tensors [R, ...], the labels
    [R, ...] and the sample weights [R, W] or None, R rows."""

    feats: Dict[str, torch.Tensor]
    labels: torch.Tensor
    weights: Optional[torch.Tensor]

    @property
    def nbytes(self) -> int:
        """The bytes the resident arrays hold on the device."""
        tensors = [*self.feats.values(), self.labels,
                   *(() if self.weights is None else (self.weights,))]
        return sum(t.numel() * t.element_size() for t in tensors)

    def take(self, idx: torch.Tensor, data_group=None):
        """(feats, labels, weights) of the rows ``idx`` (int64 [B] on the
        device), gathered on the device.  With a ``data_group`` ``idx`` is
        the global batch: the features are this rank's rows of it, the
        labels and weights all of them."""
        rows = idx if data_group is None else data_group.local_rows(idx)
        feats = {k: v.index_select(0, rows) for k, v in self.feats.items()}
        weights = None if self.weights is None else self.weights.index_select(0, idx)
        return feats, self.labels.index_select(0, idx), weights


def capture_graph(fn: Callable, generator: Optional[torch.Generator] = None, state=(),
                  warmup: int = GRAPH_WARMUP, pool=None):
    """Record ``fn()`` into a torch.cuda.CUDAGraph; returns (graph, what the
    recorded call returned).  Recording runs nothing: call ``replay``.

    ``fn`` takes no arguments.  It reads and writes tensors that stay where
    they are, and a replay repeats it on whatever those hold then.  First
    ``fn`` runs ``warmup`` times eagerly on a side stream, so that cuBLAS,
    the allocator and the kernels' cached queries and scratch (the
    LayerNorm backward's tickets) are set up before the capture; the
    tensors in ``state`` and the generator's state are saved before and
    restored after, so the warm-up leaves no trace.  The generator is
    registered with the graph: each replay draws from where it stands and
    advances it as the same calls made eagerly would.  ``pool`` (from
    torch.cuda.graph_pool_handle) records into a pool shared with other
    graphs; None gives the graph its own.  A capture that fails raises;
    nothing falls back to eager calls."""
    saved = [t.clone() for t in state]
    gen_state = generator.get_state() if generator is not None else None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    if generator is not None:
        generator.set_state(gen_state)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def _shape_key(*tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors if t is not None)


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: object         # the static tensors a call copies its inputs into
    out: object            # what the recorded call returned
    pins: tuple = ()       # objects the key names by id
    collectives: int = 0   # the data and model groups' collectives the recording holds


class TrainPrograms:
    """The train variants of JAX build_train_step over one model, optimizer
    and generator:

    * ``single(feats, labels, weights)``: one step;
    * ``stacked(feats_k, labels_k, weights_k)``: K steps over K batches
      stacked on a leading axis;
    * ``feed(resident, idx_k)``: K steps over the rows ``idx_k`` (int64
      [K, B] on the device) of a Resident dataset.

    Each step adds its metrics (METRICS) into ``metric_sums`` in step order,
    so an epoch's sums do not depend on how its steps are grouped; each
    variant also returns its steps' metrics ([M], or [K, M]).  On a CUDA
    device every step launches the section marks of train/profiler.py
    (``MARKS``, from ``step`` before the row gather or the forward to
    ``end`` after the metric sums), recorded into the graphs.  The model
    gets ``epoch`` (a 0-dim float32 tensor), ``fds_state`` and
    ``fds_bucket``; ``set_epoch`` and ``set_fds_state`` write the first two
    in place.  A stateful task loss (losses/zoo.py GHMCState: the JAX
    package's loss state) writes its state in place each step; its
    ``graph_state`` is restored after a capture's warm-ups with the
    optimizer's.  ``state_dict`` names every tensor a step carries to the
    next (the optimizer's buffers, the FDS state, the loss state), the
    generator's state and the frozen parameters' names; ``load_state``
    copies such a state back in place.

    On a CUDA device each K variant is one CUDA graph of K whole steps
    (forward, autograd.grad, clip + Adam + apply and the metrics), recorded
    at its first call for each (variant, K, input shapes and dtypes: B, N,
    L among them, compute dtype, the LayerNorm kernels' setting in force
    (ops/hopper_ln.py ln_kernels_on), resident dataset) and
    replayed after; ``single`` runs eagerly.  On the CPU the K variants run
    their steps as a loop.

    Under data parallelism (the optimizer's ``data_group``) the features
    a variant takes are this rank's rows (``feed`` takes the global index
    block and picks them), the labels and weights the global batch's; the
    generator is this rank's own stream (parallel/mesh.py rank_seed), and
    ``state_dict`` holds every rank's generator state.  The graphs hold the
    step's collectives under NCCL; under gloo the K variants run eagerly,
    as on the CPU.  The collectives run at every group size, one rank
    too."""

    def __init__(self, model, optimizer: FusedAdam, loss_fn: Callable, task: str,
                 generator: torch.Generator, fds_state=None, fds_bucket=(0.0, 1.0), **loss_kw):
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.loss_fn = loss_fn
        self.data_group = optimizer.data_group
        self.model_group = optimizer.model_group
        self._train_step = build_train_step(model, optimizer, loss_fn, task,
                                            data_group=self.data_group, **loss_kw)
        self.device = optimizer._flat.device
        groups = [g for g in (self.data_group, self.model_group) if g is not None]
        self.use_graphs = self.device.type == "cuda" and all(g.recordable for g in groups)
        if self.device.type == "cuda" and not self.use_graphs:
            logger.info("the %s group's collectives cannot be recorded into a CUDA graph: "
                        "train steps run eagerly, one dispatch each", groups[0].backend)
        self.epoch = torch.zeros((), dtype=torch.float32, device=self.device)
        self.fds_state = (None if fds_state is None
                          else {k: v.detach().clone() for k, v in fds_state.items()})
        self.fds_bucket = fds_bucket
        self.metric_sums = torch.zeros(len(METRICS), dtype=torch.float32, device=self.device)
        self.loss_state = tuple(getattr(loss_fn, "graph_state", ()))
        self.graphs: Dict[tuple, _Graph] = {}

    @torch.no_grad()
    def set_epoch(self, epoch: int) -> None:
        self.epoch.fill_(float(epoch))

    @torch.no_grad()
    def set_fds_state(self, state: Mapping[str, torch.Tensor]) -> None:
        # staged: an entry of ``state`` may be one of ours under another
        # name (fds_update_last_epoch_stats rolls running_mean into
        # running_mean_last_epoch by reference)
        staged = {k: state[k].clone() for k in self.fds_state}
        for k, v in self.fds_state.items():
            v.copy_(staged[k])

    def state_dict(self) -> Dict[str, object]:
        """What a step carries to the next, by name (the live tensors; under
        tensor parallelism the optimizer's as the whole model's, gathered)
        and the generator's state (a copy)."""
        state = {"optimizer": self.optimizer.full_named_state(),
                 "generator": self.generator.get_state(),
                 "frozen": sorted(self.optimizer.frozen)}
        if self.data_group is not None:
            # a collective: every rank calls state_dict, rank 0 writes it
            state["rank_generators"] = self.data_group.gather_objects(
                self.generator.get_state())
        if self.fds_state is not None:
            state["fds"] = dict(self.fds_state)
        if hasattr(self.loss_fn, "state_dict"):
            state["loss"] = self.loss_fn.state_dict()
        return state

    @torch.no_grad()
    def load_state(self, state: Mapping[str, object]) -> None:
        """Copy a ``state_dict`` (tensors on any device) back in place.  A
        state saved with another frozen set raises."""
        saved = sorted(state.get("frozen", []))
        if saved != sorted(self.optimizer.frozen):
            raise ValueError(
                f"the saved train state froze {len(saved)} parameter tensors and this fit "
                f"freezes {len(self.optimizer.frozen)}, not the same ones "
                f"({sorted(set(saved) ^ set(self.optimizer.frozen))[:5]} differ): resume with "
                "the freeze_layers, freeze_layers_reversed and freeze_module of the saved run")
        self.optimizer.load_named_state(state["optimizer"])
        if ("fds" in state) != (self.fds_state is not None) or (
                "loss" in state) != hasattr(self.loss_fn, "state_dict"):
            raise ValueError("the saved train state was made with other FDS or loss settings")
        if self.fds_state is not None:
            self.set_fds_state(state["fds"])
        if "loss" in state:
            self.loss_fn.load_state_dict(state["loss"])
        streams = state.get("rank_generators", [state["generator"]])
        ranks, rank = (1, 0) if self.data_group is None else (self.data_group.size,
                                                              self.data_group.rank)
        if len(streams) != ranks:
            raise ValueError(f"the saved train state was made by {len(streams)} data-parallel "
                             f"process(es) and this fit runs {ranks}: each rank's dropout "
                             "stream resumes only on as many processes")
        self.generator.set_state(streams[rank])

    @torch.no_grad()
    def broadcast_state(self) -> None:
        """Every rank takes rank 0's parameters, optimizer state, FDS and
        loss state (a data-parallel fit's start; the generators stay each
        rank's own)."""
        fds = () if self.fds_state is None else self.fds_state.values()
        self.data_group.broadcast_([*self.optimizer.graph_state, *fds, *self.loss_state])

    def single(self, feats, labels, weights=None) -> torch.Tensor:
        mark("step", labels)
        return self._step(feats, labels, weights)

    def _step(self, feats, labels, weights) -> torch.Tensor:
        """One step after its ``step`` mark, through the ``end`` mark."""
        rows = labels if self.data_group is None else self.data_group.local_rows(labels)
        metrics = self._train_step(feats, labels, weights, self.generator,
                                   fds_state=self.fds_state, net_target=rows.float(),
                                   epoch=self.epoch, fds_bucket=self.fds_bucket)
        m = torch.stack([metrics[k] for k in METRICS])
        self.metric_sums.add_(m)
        mark("end", m)
        return m

    def stacked(self, feats_k: Mapping[str, torch.Tensor], labels_k: torch.Tensor,
                weights_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        names = sorted(feats_k)
        inputs = (*(feats_k[n] for n in names), labels_k, weights_k)

        def run(*xs):
            *fs, labels, weights = xs
            feats = dict(zip(names, fs))
            return torch.stack([
                self.single({n: v[k] for n, v in feats.items()}, labels[k],
                           None if weights is None else weights[k])
                for k in range(labels.shape[0])])

        if not self.use_graphs:
            return run(*inputs)
        key = ("stacked", labels_k.shape[0], *_shape_key(*inputs))
        return self._replay(key, run, inputs)

    def feed(self, resident: Resident, idx_k: torch.Tensor) -> torch.Tensor:
        """The K steps, in the trace's ``train.feed`` span while a
        profiler records: the host's time to hand them to the card."""
        def run(idx):
            steps = []
            for k in range(idx.shape[0]):
                mark("step", idx)
                steps.append(self._step(*resident.take(idx[k], self.data_group)))
            return torch.stack(steps)

        with span("train.feed"):
            if not self.use_graphs:
                return run(idx_k)
            key = ("feed", idx_k.shape[0], *_shape_key(idx_k, *resident.feats.values(),
                                                       resident.labels), id(resident))
            return self._replay(key, run, (idx_k,), pins=(resident,))

    def _replay(self, key, run, inputs, pins=()) -> torch.Tensor:
        key = (*key, self.model.compute_dtype, ln_kernels_on(self.device))
        prog = self.graphs.get(key)
        if prog is None:
            static = tuple(None if x is None else x.clone() for x in inputs)
            groups = [g for g in (self.data_group, self.model_group) if g is not None]
            calls = sum(g.calls for g in groups)
            graph, out = capture_graph(lambda: run(*static), self.generator,
                                       state=(*self.optimizer.graph_state, self.metric_sums,
                                              *self.loss_state))
            # the warm-ups and the recording issued the same collectives
            held = (sum(g.calls for g in groups) - calls) // (GRAPH_WARMUP + 1)
            prog = self.graphs[key] = _Graph(graph, static, out, pins, held)
        with torch.no_grad():
            for dst, src in zip(prog.inputs, inputs):
                if dst is not None:
                    dst.copy_(src)
        prog.graph.replay()
        return prog.out.clone()


class EvalSweep:
    """JAX build_eval_sweep: the deterministic forward over a Resident
    dataset, batch by batch.  ``sweep(resident, idx, valid_ns)`` with idx
    int64 [nb, B] and valid_ns int64 [nb] on the device returns preds
    [nb, B, ...] and losses [nb]; with ``with_pooled`` also the pooled
    features [nb*B, E] and the labels as float32 [nb*B, ...] (the FDS
    pass).

    On a CUDA device one batch's forward is one CUDA graph per (resident
    dataset, input shapes and dtypes, compute dtype, the LayerNorm
    kernels' setting in force),
    recorded at first use; the sweep replays it once per batch and copies
    each replay's outputs into its own.  On the CPU, and for a model whose
    model group is gloo's, the batches run eagerly."""

    def __init__(self, model, loss_fn: Callable, activation_fn: Callable, alpha: float = 1.0,
                 with_pooled: bool = False):
        self.model = model
        group = getattr(model, "model_group", None)
        # a model group whose collectives a graph cannot hold (gloo) sweeps
        # eagerly
        self.use_graphs = group is None or group.recordable
        self.eval_step = build_eval_step(model, loss_fn, activation_fn, alpha)
        self.with_pooled = with_pooled
        self.graphs: Dict[tuple, _Graph] = {}

    def _batch(self, resident: Resident, idx: torch.Tensor, valid_n: torch.Tensor):
        feats, labels, _ = resident.take(idx)
        preds, loss, pooled, _ = self.eval_step(feats, labels, valid_n)
        return (preds, loss, pooled, labels.float()) if self.with_pooled else (preds, loss)

    def __call__(self, resident: Resident, idx: torch.Tensor, valid_ns: torch.Tensor):
        nb = idx.shape[0]
        if idx.device.type != "cuda" or not self.use_graphs:
            outs = [torch.stack(o) for o in
                    zip(*(self._batch(resident, idx[b], valid_ns[b]) for b in range(nb)))]
        else:
            key = (*_shape_key(idx[0], *resident.feats.values(), resident.labels), id(resident),
                   self.model.compute_dtype, ln_kernels_on(idx.device))
            prog = self.graphs.get(key)
            if prog is None:
                static = (idx[0].clone(), valid_ns[0].clone())
                graph, out = capture_graph(lambda: self._batch(resident, *static))
                prog = self.graphs[key] = _Graph(graph, static, out, (resident,))
            outs = [torch.empty((nb, *o.shape), dtype=o.dtype, device=o.device)
                    for o in prog.out]
            with torch.no_grad():
                for b in range(nb):
                    prog.inputs[0].copy_(idx[b])
                    prog.inputs[1].copy_(valid_ns[b])
                    prog.graph.replay()
                    for dst, src in zip(outs, prog.out):
                        dst[b].copy_(src)
        if not self.with_pooled:
            return outs[0], outs[1]
        return outs[0], outs[1], outs[2].flatten(0, 1), outs[3].flatten(0, 1)
