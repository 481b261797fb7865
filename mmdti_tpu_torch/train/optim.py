"""Clip + Adam + apply (port of mmdti_tpu/train/optim.py::make_fused_apply).

Adam with eps 1e-6 and no weight decay, the HF linear warmup -> linear decay
schedule, global-norm clipping before the update, and the first moment
stored in bf16 (computed in fp32; the second moment and the parameters stay
fp32).  Parameters marked frozen get a zero gradient before the clip, so
they neither count toward the global norm nor move.

The arithmetic follows the JAX fused apply op for op, including where its
types promote: ``b1 * mu`` is taken in the stored mu dtype, with b1 itself
rounded to that dtype first (JAX's weak-typed Python float becomes a bf16
constant), before the fp32 sum.
The parameters are updated in place, so no second parameter set exists.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-6


def linear_warmup_schedule(learning_rate: float, num_training_steps: int,
                           warmup_ratio: float):
    """step -> learning rate (np.float32): linear warmup over
    int(num_training_steps * warmup_ratio) steps, then linear decay to 0."""
    num_warmup = int(num_training_steps * warmup_ratio)
    f32 = np.float32

    def schedule(step: int) -> np.float32:
        step = f32(step)
        warm = step / f32(max(1.0, num_warmup))
        decay = (f32(num_training_steps) - step) / f32(max(1.0, num_training_steps - num_warmup))
        factor = warm if step < num_warmup else decay
        return f32(learning_rate) * f32(np.clip(factor, f32(0.0), f32(1.0)))

    return schedule


@dataclasses.dataclass
class AdamState:
    """Adam's moments by parameter name, its step count and the schedule's
    step count (optax keeps the two counts apart)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: int


class FusedAdam:
    """Global-norm clip, Adam and the parameter update in one call.

    ``params`` maps names to the model's fp32 parameters
    (``named_parameters``); ``frozen`` names the ones that must not move.

    The parameters become views into one flat fp32 buffer, beside flat
    buffers for the moments, so an update is a dozen elementwise kernels
    over the whole model instead of ~20 per parameter tensor (the JAX fused
    apply's one fusion per leaf, in PyTorch's terms).  Elementwise, the
    arithmetic is the per-leaf arithmetic.  Build the optimizer after the
    model is on its device: moving the model afterwards detaches its
    parameters from the buffer.  ``state`` holds per-name views of the
    moment buffers; ``load_state`` copies a state in."""

    def __init__(self, params: Mapping[str, torch.Tensor], learning_rate: float,
                 num_training_steps: int, warmup_ratio: float = 0.03, max_norm: float = 5.0,
                 eps: float = ADAM_EPS, b1: float = ADAM_B1, b2: float = ADAM_B2,
                 frozen: Optional[Iterable[str]] = None, mu_dtype=torch.bfloat16):
        self.params = dict(params)
        self.schedule = linear_warmup_schedule(learning_rate, num_training_steps, warmup_ratio)
        self.max_norm = float(max_norm)
        self.eps, self.b1, self.b2 = eps, b1, b2
        frozen = frozenset(frozen or ())
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
        self.state = AdamState(
            count=0,
            mu={n: self._view(self._mu, n) for n in self.params},
            nu={n: self._view(self._nu, n) for n in self.params},
            schedule_count=0,
        )

    def _view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        off, shape = self._slices[name]
        return flat[off:off + shape.numel()].view(shape)

    @torch.no_grad()
    def load_state(self, state: AdamState) -> None:
        """Copy ``state`` (moments by parameter name, counts) in."""
        for n in self.params:
            self.state.mu[n].copy_(state.mu[n])
            self.state.nu[n].copy_(state.nu[n])
        self.state.count, self.state.schedule_count = state.count, state.schedule_count

    @torch.no_grad()
    def apply(self, grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """One update from ``grads`` (name -> gradient; None counts as zero).
        Returns the global norm of the gradients before clipping."""
        st = self.state
        g = torch.cat([(torch.zeros_like(p) if grads.get(n) is None else grads[n]).reshape(-1)
                       for n, p in self.params.items()]).float()
        if self._trained is not None:
            g = torch.where(self._trained, g, torch.zeros((), device=g.device))
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < self.max_norm, g, (g / g_norm) * self.max_norm)
        f32 = np.float32
        count = st.count + 1
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        step_size = float(-self.schedule(st.schedule_count))
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + self._mu * torch.tensor(b1, dtype=self._mu.dtype)
        nu = (1 - b2) * (g * g) + b2 * self._nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        self._flat.add_(step_size * u)
        self._mu.copy_(mu)
        self._nu.copy_(nu)
        st.count = count
        st.schedule_count += 1
        return g_norm
