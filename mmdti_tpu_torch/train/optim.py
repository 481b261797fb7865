"""Clip + Adam + apply (port of mmdti_tpu/train/optim.py::make_fused_apply).

Adam with eps 1e-6 and no weight decay, the HF linear warmup -> linear decay
schedule, global-norm clipping before the update, and the first moment
stored in bf16 (computed in fp32; the second moment and the parameters stay
fp32).  Parameters marked frozen get a zero gradient before the clip, so
they neither count toward the global norm nor move.  Under data
parallelism (``data_group``, parallel/mesh.py) the flat gradient is
averaged over the ranks first, one collective a call, so the norm, the
clip and the update are the same on every rank.  Under tensor parallelism
(``model_group``) the flat buffers hold this model rank's shard: the
global norm adds every shard's sum of squares of its sharded tensors (one
all-reduce over the model group) to the replicated tensors' own, counted
once, and ``full_named_state`` / ``load_named_state`` move the buffers as
the whole model's.

The arithmetic follows the JAX fused apply op for op, including where its
types promote: ``b1 * mu`` is taken in the stored mu dtype, with b1 itself
rounded to that dtype first (JAX's weak-typed Python float becomes a bf16
constant), before the fp32 sum.
The parameters are updated in place, so no second parameter set exists.

The step counts live on the device, and so do the bias corrections and the
learning rate they select (tables of the host float32 values, indexed by
the counts): an update issues no host work that depends on the step, so a
CUDA graph can replay it (train/steps.py).  ``accumulate_steps=k`` is the
twin of optax.MultiSteps around the clip + Adam chain: every mini-step
folds its gradients into a running fp32 mean, and every k-th applies clip +
Adam to that mean; ``torch.where`` on a device counter picks which, so one
graph holds both kinds of mini-step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from mmdti_tpu_torch.parallel.mesh import full_shape, shard_tensor, tp_rule

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-6


def linear_warmup_schedule(learning_rate: float, num_training_steps: int,
                           warmup_ratio: float):
    """step -> learning rate (np.float32): linear warmup over
    int(num_training_steps * warmup_ratio) steps, then linear decay to 0."""
    num_warmup = int(num_training_steps * warmup_ratio)
    f32 = np.float32

    def schedule(step):
        """step (an int or an array of them) -> np.float32 learning rate(s);
        every operation is a correctly rounded float32 one, so an array
        gives the scalar values element by element."""
        step = np.asarray(step, f32)
        warm = step / f32(max(1.0, num_warmup))
        decay = (f32(num_training_steps) - step) / f32(max(1.0, num_training_steps - num_warmup))
        factor = np.where(step < num_warmup, warm, decay)
        return f32(learning_rate) * np.clip(factor, f32(0.0), f32(1.0)).astype(f32)

    return schedule


@functools.lru_cache(maxsize=None)
def _bias_correction(b: float) -> np.ndarray:
    """float32 ``1 - b ** count`` for count = 0, 1, ... up to the first count
    where it rounds to exactly 1.0 (every later count gives 1.0 too, so an
    index clamped to the end is exact).  Each entry is the scalar float32
    expression the update took on the host, entry by entry."""
    f32 = np.float32
    out, count = [], 0
    while not out or out[-1] != f32(1.0):
        out.append(f32(1.0) - f32(b) ** f32(count))
        count += 1
    return np.asarray(out, f32)


@dataclasses.dataclass
class AdamState:
    """Adam's moments by parameter name, its step count and the schedule's
    step count (optax keeps the two counts apart), and with
    ``accumulate_steps > 1`` optax.MultiSteps' running gradient mean
    (flat) and mini-step count.  ``FusedAdam.state`` reads the counts back
    from the device."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: int
    acc: Optional[torch.Tensor] = None
    mini: int = 0


class FusedAdam:
    """Global-norm clip, Adam and the parameter update in one call.

    ``params`` maps names to the model's fp32 parameters
    (``named_parameters``); ``frozen`` names the ones that must not move;
    ``data_group`` (parallel/mesh.py DataGroup, or None) is the data axis
    the gradients are averaged over; ``model_group`` (a ModelGroup, or
    None) the model axis whose shards the parameters are.

    The parameters become views into one flat fp32 buffer, beside flat
    buffers for the moments, so an update is a dozen elementwise kernels
    over the whole model instead of ~20 per parameter tensor (the JAX fused
    apply's one fusion per leaf, in PyTorch's terms).  Elementwise, the
    arithmetic is the per-leaf arithmetic.  Build the optimizer after the
    model is on its device: moving the model afterwards detaches its
    parameters from the buffer.  ``state`` holds per-name views of the
    moment buffers; ``load_state`` copies a state in.

    ``num_training_steps`` counts optimizer updates: with
    ``accumulate_steps=k`` an update comes every k-th call of ``apply``.
    The buffers a CUDA graph holds (``graph_state``) are never rebound:
    every write to them is in place."""

    def __init__(self, params: Mapping[str, torch.Tensor], learning_rate: float,
                 num_training_steps: int, warmup_ratio: float = 0.03, max_norm: float = 5.0,
                 eps: float = ADAM_EPS, b1: float = ADAM_B1, b2: float = ADAM_B2,
                 frozen: Optional[Iterable[str]] = None, mu_dtype=torch.bfloat16,
                 accumulate_steps: int = 1, data_group=None, model_group=None):
        self.params = dict(params)
        self.data_group = data_group
        self.model_group = (model_group if model_group is not None and model_group.size > 1
                            else None)
        self.schedule = linear_warmup_schedule(learning_rate, num_training_steps, warmup_ratio)
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        self.max_norm = float(max_norm)
        self.eps, self.b1, self.b2 = eps, b1, b2
        frozen = self.frozen = frozenset(frozen or ())
        unknown = frozen - set(self.params)
        if unknown:
            raise KeyError(f"frozen names that are not parameters: {sorted(unknown)}")
        devices = {p.device for p in self.params.values()}
        if len(devices) != 1 or any(p.dtype != torch.float32 for p in self.params.values()):
            raise ValueError("FusedAdam takes fp32 parameters on one device")
        self._slices, off = {}, 0
        for n, p in self.params.items():
            self._slices[n] = (off, p.shape)
            off += p.numel()
        self._flat = torch.cat([p.detach().reshape(-1) for p in self.params.values()])
        for n, p in self.params.items():
            p.data = self._view(self._flat, n)
        self._mu = torch.zeros(off, dtype=mu_dtype, device=self._flat.device)
        self._nu = torch.zeros(off, dtype=torch.float32, device=self._flat.device)
        self._trained = None
        if frozen:
            self._trained = torch.ones(off, dtype=torch.bool, device=self._flat.device)
            for n in frozen:
                self._view(self._trained, n).fill_(False)
        self._sharded = None
        if self.model_group is not None:
            # the entries of the tensors that are this shard's part of theirs
            self._sharded = torch.zeros(off, dtype=torch.bool, device=self._flat.device)
            for n in self.params:
                if tp_rule(n) is not None:
                    self._view(self._sharded, n).fill_(True)
        self._mu_views = {n: self._view(self._mu, n) for n in self.params}
        self._nu_views = {n: self._view(self._nu, n) for n in self.params}
        dev = self._flat.device
        # [Adam's count, the schedule's count]; the tables they index: the
        # bias corrections by count (clamped: exact past the end) and the
        # learning rate by schedule count (0 from num_training_steps on)
        self._counts = torch.zeros(2, dtype=torch.int64, device=dev)
        self._bc1 = torch.tensor(_bias_correction(b1), device=dev)
        self._bc2 = torch.tensor(_bias_correction(b2), device=dev)
        n_sched = max(int(num_training_steps), 0)
        self._lr = torch.from_numpy(
            self.schedule(np.arange(n_sched + 1)).astype(np.float32)).to(dev)
        if self.accumulate_steps > 1:
            self._acc = torch.zeros(off, dtype=torch.float32, device=dev)
            self._mini = torch.zeros((), dtype=torch.int64, device=dev)

    @property
    def state(self) -> AdamState:
        """The moments (views of the flat buffers), the counts read from the
        device, and the accumulation buffer and mini-step count."""
        count, schedule_count = self._counts.tolist()
        acc, mini = None, 0
        if self.accumulate_steps > 1:
            acc, mini = self._acc, int(self._mini)
        return AdamState(count=count, mu=self._mu_views, nu=self._nu_views,
                         schedule_count=schedule_count, acc=acc, mini=mini)

    @property
    def named_state(self) -> Dict[str, torch.Tensor]:
        """Every tensor an update writes, by name: the flat parameters,
        moments, counts and (accumulating) the running mean and mini-step
        count."""
        state = {"params": self._flat, "mu": self._mu, "nu": self._nu, "counts": self._counts}
        if self.accumulate_steps > 1:
            state.update(acc=self._acc, mini=self._mini)
        return state

    @property
    def graph_state(self):
        """Every tensor an update writes: a caller that runs updates it must
        undo (a CUDA graph's warm-up) saves and restores these."""
        return list(self.named_state.values())

    # the flat buffers that hold one entry per parameter entry
    _PER_PARAM = ("params", "mu", "nu", "acc")

    def full_named_state(self) -> Dict[str, torch.Tensor]:
        """``named_state`` as the whole model's: under tensor parallelism the
        per-parameter buffers gathered over the model group (a collective;
        CPU tensors), in the layout one process's FusedAdam over the whole
        model holds; else ``named_state`` itself."""
        state = self.named_state
        if self.model_group is None:
            return state
        out = dict(state)
        for k in self._PER_PARAM:
            if k in state:
                whole = self.model_group.gather_state_dict(
                    {n: self._view(state[k], n) for n in self.params})
                out[k] = torch.cat([whole[n].reshape(-1) for n in self.params])
        return out

    def _shard_state(self, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole model's ``named_state`` cut to this shard's."""
        g = self.model_group
        out = dict(state)
        for k in self._PER_PARAM:
            if k not in state:
                continue
            flat, off, parts = state[k], 0, []
            for n in self.params:
                shape = full_shape(n, self._slices[n][1], g.size)
                count = int(np.prod(shape, dtype=np.int64))
                parts.append(shard_tensor(n, flat[off:off + count].view(shape), g.index,
                                          g.size).reshape(-1))
                off += count
            if off != flat.numel():
                raise ValueError(f"optimizer state {k!r} holds {flat.numel()} entries, the "
                                 f"whole model {off}")
            out[k] = torch.cat(parts)
        return out

    @torch.no_grad()
    def load_named_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy a ``named_state`` in, in place; the names must match.  Under
        tensor parallelism ``state`` is the whole model's
        (``full_named_state``)."""
        if self.model_group is not None:
            state = self._shard_state(state)
        mine = self.named_state
        if set(state) != set(mine):
            raise ValueError(f"optimizer state holds {sorted(state)}, this optimizer "
                             f"{sorted(mine)} (another accumulate_steps?)")
        for k, t in mine.items():
            if tuple(state[k].shape) != tuple(t.shape) or state[k].dtype != t.dtype:
                raise ValueError(f"optimizer state {k!r}: {tuple(state[k].shape)} "
                                 f"{state[k].dtype}, expected {tuple(t.shape)} {t.dtype}")
            t.copy_(state[k])

    @torch.no_grad()
    def reset(self) -> None:
        """Moments, counts and accumulation back to zero, in place (the
        parameters stay): a fresh optimizer over the same buffers."""
        for k, t in self.named_state.items():
            if k != "params":
                t.zero_()

    def _view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        off, shape = self._slices[name]
        return flat[off:off + shape.numel()].view(shape)

    @torch.no_grad()
    def load_state(self, state: AdamState) -> None:
        """Copy ``state`` (moments by parameter name, counts, and the
        accumulation buffer and mini-step count) in, in place."""
        for n in self.params:
            self._mu_views[n].copy_(state.mu[n])
            self._nu_views[n].copy_(state.nu[n])
        self._counts.copy_(torch.tensor([state.count, state.schedule_count]))
        if self.accumulate_steps > 1:
            if state.acc is None:
                self._acc.zero_()
            else:
                self._acc.copy_(state.acc)
            self._mini.fill_(int(state.mini))

    def _pick(self, table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """table[min(index, end)] as a 0-dim tensor, without a host sync."""
        return table.index_select(0, index.clamp(max=table.numel() - 1).view(1))[0]

    @torch.no_grad()
    def apply(self, grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """One call from ``grads`` (name -> gradient; None counts as zero):
        an update, or with ``accumulate_steps=k`` a mini-step that updates
        on every k-th call.  Returns the global norm of the gradients that
        were (or would be) clipped."""
        g = torch.cat([(torch.zeros_like(p) if grads.get(n) is None else grads[n]).reshape(-1)
                       for n, p in self.params.items()]).float()
        if self.data_group is not None:
            self.data_group.average_(g)
        if self._trained is not None:
            g = torch.where(self._trained, g, torch.zeros((), device=g.device))
        if self.accumulate_steps == 1:
            return self._update(g, None)
        # optax.MultiSteps: the running mean acc + (g - acc) / (n + 1), and
        # clip + Adam on it when this is the k-th mini-step
        self._acc.add_((g - self._acc) / (self._mini + 1))
        emit = self._mini == self.accumulate_steps - 1
        g_norm = self._update(self._acc, emit)
        self._acc.mul_(torch.logical_not(emit))
        self._mini.copy_(torch.remainder(self._mini + 1, self.accumulate_steps))
        return g_norm

    def _update(self, g: torch.Tensor, emit: Optional[torch.Tensor]) -> torch.Tensor:
        """Clip + Adam + apply from the flat gradient g; with ``emit`` (a
        0-dim bool tensor) the parameters, moments and counts move only
        where it is true."""
        if self._sharded is None:
            g_norm = torch.sqrt(torch.sum(g * g))
        else:
            sq = g * g
            zero = torch.zeros((), device=g.device)
            shard_sq = torch.sum(torch.where(self._sharded, sq, zero)).reshape(1)
            g_norm = torch.sqrt(torch.sum(torch.where(self._sharded, zero, sq))
                                + self.model_group._all_reduce(shard_sq)[0])
        g = torch.where(g_norm < self.max_norm, g, (g / g_norm) * self.max_norm)
        count, schedule_count = self._counts[0] + 1, self._counts[1]
        bc1, bc2 = self._pick(self._bc1, count), self._pick(self._bc2, count)
        step_size = -self._pick(self._lr, schedule_count)
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + self._mu * torch.tensor(b1, dtype=self._mu.dtype)
        nu = (1 - b2) * (g * g) + b2 * self._nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if emit is None:
            self._flat.add_(step_size * u)
            self._mu.copy_(mu)
            self._nu.copy_(nu)
            self._counts.add_(1)
        else:
            self._flat.copy_(torch.where(emit, self._flat + step_size * u, self._flat))
            self._mu.copy_(torch.where(emit, mu.to(self._mu.dtype), self._mu))
            self._nu.copy_(torch.where(emit, nu, self._nu))
            self._counts.add_(emit.long())
        return g_norm
