"""PyTorch/CUDA port of mmdti_tpu for one NVIDIA H100.

Training and prediction: ``MolTrain(..., device="cuda").fit(train, val)``
writes an experiment dir (config.yaml, target_scaler.ss, model_0.ckpt in
the JAX package's flax-msgpack format, history_0.json) and
``MolPredict(load_model=dir).predict(data)`` reads it back.  Serving:
``MolServe(config, state_dict, device="cuda").predict(smiles)``.  The
model runs the hand-written Hopper kernels (ops/hopper_*.py, csrc/*.cu) on
CUDA tensors and their plain versions on CPU tensors; the LayerNorm kernels
engage under MMDTI_PALLAS_LN=1.  The package imports torch and never jax.
"""

from mmdti_tpu_torch.api.predict_api import MolPredict  # noqa: F401
from mmdti_tpu_torch.api.serve_api import MolServe  # noqa: F401
from mmdti_tpu_torch.api.train_api import MolTrain  # noqa: F401
