"""The reference's training steps and the readings that decide ``correct``.

``follow`` takes the benchmark's weights, the batches of the first steps
and the dropout seed, and runs plain Adam (eps 1e-6, no weight decay,
global-norm clipping before the update, the linear warmup and decay
schedule) over the reference's loss; it returns the same readings that the
harness takes from the program:

* ``losses``: each step's total loss;
* ``grads``: each parameter's first gradient as the optimizer gets it,
  before its global-norm clip (the clip scales every parameter by one
  factor, which a single ill-conditioned parameter can set: a Gaussian
  width drawn near 0 has a gradient that dwarfs the rest);
* ``change_norms``: the norm of each parameter's change after the steps.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from h100_bench.reference.model import Draws, Reference, train_loss
from h100_bench.reference.numerics import Numerics, no_tf32


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of update ``step`` (0 for the first): a linear
    warmup over int(total * ratio) updates, then a linear decay to 0."""
    total = opt["schedule_steps"]
    warm = int(total * opt["warmup_ratio"])
    f32 = np.float32
    if step < warm:
        factor = f32(step) / f32(max(1, warm))
    else:
        factor = (f32(total) - f32(step)) / f32(max(1, total - warm))
    return float(f32(opt["learning_rate"]) * np.clip(factor, f32(0.0), f32(1.0)))


@no_tf32()
def follow(cfg: dict, mix: dict, weights: Dict[str, torch.Tensor], batches: List[tuple],
           dropout_seed: int, frozen: Iterable[str] = (), precision: str = "float32",
           half_batch: bool = False) -> dict:
    """The reference's readings over ``batches`` ([(features, labels)], one
    a step).  ``precision`` "fp8" is the control; ``half_batch`` leaves the
    second half of every batch out (a planted fault).  Adam keeps its first
    moment in bfloat16, as the fine-tune recipe states (the product of the
    stored moment and b1 in bfloat16, the sum with (1 - b1) g in float32,
    the update from that sum, the sum stored rounded).  Float32 products
    run with TF32 off."""
    opt = mix["optimizer"]
    dev = next(iter(weights.values())).device
    ref = Reference(cfg, Numerics(precision))
    frozen = set(frozen)
    P = {k: v.detach().clone().float().requires_grad_(k not in frozen) for k, v in weights.items()}
    names = [k for k in P if k not in frozen]
    m = {k: torch.zeros_like(P[k], dtype=torch.bfloat16) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(dropout_seed)
    draws = Draws(gen)
    b1, b2, eps = 0.9, 0.999, 1e-6
    losses, first = [], None
    for step, (feats, labels) in enumerate(batches):
        if half_batch:
            half = labels.shape[0] // 2
            feats = {k: t[:half] for k, t in feats.items()}
            labels = labels[:half]
        loss = train_loss(ref, P, feats, labels, draws, mix["loss"])
        grads = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(P[k]) if g is None else g.float() for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 0:
                first = {k: g.clone() for k, g in zip(names, grads)}
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < opt["max_norm"], torch.ones_like(norm),
                                opt["max_norm"] / norm)
            grads = [g * scale for g in grads]
            count = step + 1
            lr = lr_at(opt, step)
            for k, g in zip(names, grads):
                mu = (1 - b1) * g + m[k] * torch.tensor(b1, dtype=torch.bfloat16)
                m[k].copy_(mu)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                u = (mu / (1 - b1 ** count)) / (torch.sqrt(v[k] / (1 - b2 ** count)) + eps)
                P[k].sub_(lr * u)
    with torch.no_grad():
        change = {k: float(torch.linalg.norm(P[k] - weights[k].float())) for k in names}
    return {"losses": losses, "grads": first, "change_norms": change}


# a parameter whose reference gradient is under this share of the median
# parameter's moves by round-off alone
TINY = 1e-3
# the fewest entries of a parameter that grad_diff_128 holds: a one-entry
# bias under cancellation keeps the rounding of one sum (PERF.md section 2)
MIN_ENTRIES = 128


def compare(program: dict, ref: dict, worst: Optional[dict] = None,
            leaves: Optional[dict] = None) -> Dict[str, float]:
    """The numbers a run can compare.  Over the parameters, each gap is a
    share of the reference's norm of that parameter or of the median
    parameter's, whichever is larger:

    * ``loss_gap``: the largest |program - reference| / |reference| over the
      steps' losses;
    * ``grad_gap``: the largest gap between the program's and the
      reference's first-gradient norms;
    * ``grad_diff`` and ``grad_diff_median``: the largest and the median
      parameter's norm of the difference of the two first gradients;
    * ``grad_diff_128``: the largest of those over the parameters of at
      least ``MIN_ENTRIES`` entries;
    * ``change_gap`` and ``change_gap_median``: the largest and the median
      gap between the norms of the change after the steps, over the
      parameters whose reference gradient is at least ``TINY`` of the
      median parameter's (the others, such as a key bias under softmax,
      move by round-off alone).

    ``worst``, a dict, gets the step or parameter behind each largest
    gap; ``leaves``, a dict, gets each parameter's ``grad_diff``."""
    def largest(gaps: dict, what: str) -> float:
        key = max(gaps, key=gaps.get)
        if worst is not None:
            worst[what] = key
        return gaps[key]

    n = min(len(program["losses"]), len(ref["losses"]))
    out = {"loss_gap": largest({f"step {i + 1}": abs(program["losses"][i] - ref["losses"][i])
                                / max(abs(ref["losses"][i]), 1e-12) for i in range(n)},
                               "loss_gap")}
    names = sorted(ref["grads"])
    g_ref = {k: float(torch.linalg.norm(ref["grads"][k])) for k in names}
    g_med = float(np.median(list(g_ref.values())))
    scale = {k: max(g_ref[k], g_med, 1e-30) for k in names}
    got = {k: program["grads"][k].to(ref["grads"][k].device) for k in names}
    out["grad_gap"] = largest({k: abs(float(torch.linalg.norm(got[k])) - g_ref[k]) / scale[k]
                               for k in names}, "grad_gap")
    diff = {k: float(torch.linalg.norm(got[k] - ref["grads"][k])) / scale[k] for k in names}
    out["grad_diff"] = largest(diff, "grad_diff")
    out["grad_diff_128"] = largest({k: d for k, d in diff.items()
                                    if ref["grads"][k].numel() >= MIN_ENTRIES}, "grad_diff_128")
    if leaves is not None:
        leaves.update(diff)
    out["grad_diff_median"] = float(np.median(list(diff.values())))
    c_ref = ref["change_norms"]
    moved = [k for k in names if g_ref[k] >= TINY * g_med]
    c_med = float(np.median([c_ref[k] for k in moved]))
    change = {k: abs(program["change_norms"][k] - c_ref[k]) / max(c_ref[k], c_med, 1e-30)
              for k in moved}
    out["change_gap"] = largest(change, "change_gap")
    out["change_gap_median"] = float(np.median(list(change.values())))
    return out
