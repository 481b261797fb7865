"""PyTorch/CUDA port of mmdti_tpu for one NVIDIA H100.

Serving: ``MolServe(config, state_dict, device="cuda").predict(smiles)``
runs host featurization, bucketed collation, the MMModel forward with the
hand-written Hopper kernels (ops/hopper_*.py, csrc/*.cu) and
post-processing.  Training: train/steps.py's train step runs the forward
with dropout, the task + InfoNCE + CT loss, the backward through the
kernels' backward twins, and train/optim.py's clip + Adam.  The package
imports torch and never jax.
"""

from mmdti_tpu_torch.api.serve_api import MolServe  # noqa: F401
