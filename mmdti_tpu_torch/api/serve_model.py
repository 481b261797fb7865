"""Resident-model loading for MolServe (port of mmdti_tpu/api/serve_model.py).

Builds the model from a config dict, loads a state dict held in memory
(models/convert.py fills one from flax params), places it on the device and
returns the serving forward.  Experiment dirs (config.yaml, flax-msgpack
checkpoints, joblib scalers) and fold ensembles are not read here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from mmdti_tpu_torch.losses.registry import ACTIVATION_REGISTRY, resolve_output_dim
from mmdti_tpu_torch.models.mm_model import MMModel, build_model


@dataclass
class ResidentModel:
    model: MMModel
    forward: Callable          # (feats of device tensors) -> activated preds
    output_dim: int


def load_resident_model(
    cfg: Mapping[str, Any],
    state_dict: Mapping[str, torch.Tensor],
    task: str,
    dictionary,
    tokenizer,
    device: Union[str, torch.device],
    use_kernels: bool = True,
) -> ResidentModel:
    """Build the model on ``device`` with the given weights.

    The pair dtype defaults to bf16 on CUDA (the kernels store the threaded
    logits in bf16, as the JAX package does on its kernel path) and to fp32
    on the CPU; ``cfg["unimol_overrides"]["pair_dtype"]`` overrides it."""
    device = torch.device(device)
    unimol_overrides = dict(cfg.get("unimol_overrides") or {})
    unimol_overrides.setdefault(
        "pair_dtype", "bfloat16" if device.type == "cuda" else "float32"
    )
    output_dim = resolve_output_dim(
        task, cfg.get("num_classes"), cfg.get("multiclass_cnt")
    )
    activation = ACTIVATION_REGISTRY[task]
    model = build_model(
        output_dim=output_dim,
        atom_vocab_size=len(dictionary),
        atom_pad_idx=dictionary.pad(),
        smiles_vocab_size=getattr(tokenizer, "vocab_size", 600),
        compute_dtype=cfg.get("compute_dtype", "bfloat16"),
        use_kernels=use_kernels,
        unimol_overrides=unimol_overrides,
        chemberta_overrides=dict(cfg.get("chemberta_overrides") or {}) or None,
        crossmodal_overrides=dict(cfg.get("crossmodal_overrides") or {}) or None,
    )
    model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()

    @torch.inference_mode()
    def _forward(feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        return activation(model(**feats, outputs="logits")["logits"])

    return ResidentModel(model=model, forward=_forward, output_dim=output_dim)


def postprocess_predictions(
    task: str,
    raw: np.ndarray,
    scaler=None,
    threshold: Union[float, np.ndarray] = 0.5,
    multiclass_cnt: Optional[int] = None,
) -> Dict[str, Any]:
    """Map activated model outputs to MolPredict's output contract:
    regression outputs are inverse-scaled (``scaler`` is any object with
    ``inverse_transform``, or None), classification probabilities are
    binarized with the threshold, multiclass takes the argmax.

    Returns {"predict": ndarray, "proba": ndarray | None}."""
    raw = np.asarray(raw)
    if task == "multiclass":
        if multiclass_cnt is not None and raw.shape[-1] != multiclass_cnt:
            raise ValueError(
                f"multiclass output width {raw.shape[-1]} != multiclass_cnt {multiclass_cnt}"
            )
        return {"predict": np.argmax(raw, axis=-1).reshape(-1, 1), "proba": raw}
    if task in ("classification", "multilabel_classification"):
        return {"predict": (raw > threshold).astype(np.int64), "proba": raw}
    if scaler is not None:
        raw = scaler.inverse_transform(raw)
    return {"predict": raw, "proba": None}
