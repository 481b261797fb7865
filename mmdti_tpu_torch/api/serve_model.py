"""Resident-model loading for MolServe (port of mmdti_tpu/api/serve_model.py).

Builds the model from an experiment dir's config, loads the fold
checkpoint(s) (``model_{fold}.ckpt``, flax-msgpack, as train/trainer.py's
``load_weights`` reads them) onto the device and returns the serving
forward and embed.  A fold ensemble keeps K models resident; its forward
is the mean of the K activated outputs, MolPredict's ensemble algebra.
The JAX package vmaps stacked parameters; the port's kernels are ctypes
launches that ``torch.func.vmap`` cannot map, so the K forwards run in a
row (on the card inside one CUDA graph, api/serve_api.py).

A tensor-parallel replica (``devices``: its m shards' devices) holds m
models, shard i built with its handle of one ``ReplicaShards``
(parallel/mesh.py) and loaded with its shard of each checkpoint; its
forward runs the m shards in lockstep and returns the first shard's
output (every shard computes the same).  A fold ensemble on a model axis
raises, as the JAX package's does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mmdti_tpu_torch.losses.registry import ACTIVATION_REGISTRY, resolve_output_dim
from mmdti_tpu_torch.models.convert import chemberta_overrides, flax_params_to_state_dict
from mmdti_tpu_torch.models.mm_model import MMModel, build_model
from mmdti_tpu_torch.parallel.mesh import ReplicaShards, shard_state_dict
from mmdti_tpu_torch.train.checkpointing import load_checkpoint

TP_FOLDS_REFUSED = ("serve_folds > 1 with a tensor-parallel mesh (model axis > 1) is "
                    "unsupported; use a pure data-parallel mesh_shape=(n, 1)")

logger = logging.getLogger("mmdti_tpu_torch")


@dataclass
class ResidentModel:
    models: List[MMModel]      # one per served fold, fold 0 first (shard 0's on a model axis)
    forward: Callable          # (feats of device tensors) -> activated preds, fold mean
    embed: Callable            # (feats) -> (cls_repr, pooled) of fold 0
    output_dim: int
    serve_folds: int

    @property
    def model(self) -> MMModel:
        return self.models[0]


def resident_model(
    cfg: Mapping[str, Any],
    state_dicts: Sequence[Mapping[str, torch.Tensor]],
    task: str,
    dictionary,
    tokenizer,
    device: Union[str, torch.device, Sequence],
    use_kernels: bool = True,
) -> ResidentModel:
    """One model per state dict, built on ``device`` as train/nnmodel.py
    builds it (``use_fds`` from the config, so an FDS-trained checkpoint
    loads strictly; serving never smooths; the ChemBERTa dims of a
    ``chemberta_dir`` under the saved overrides; the weights are the state
    dicts', never the pretrained files').  The pair dtype defaults to
    bf16 on CUDA and fp32 on the CPU; ``cfg["unimol_overrides"]
    ["pair_dtype"]`` overrides it.  ``device`` a list of m > 1 devices:
    one tensor-parallel replica of one fold, shard i on the i-th."""
    if isinstance(device, (list, tuple)):
        return _sharded_replica(cfg, state_dicts, task, dictionary, tokenizer,
                                [torch.device(d) for d in device], use_kernels)
    device = torch.device(device)
    output_dim = resolve_output_dim(
        task, cfg.get("num_classes"), cfg.get("multiclass_cnt")
    )
    activation = ACTIVATION_REGISTRY[task]
    models = []
    for sd in state_dicts:
        model = _build(cfg, task, dictionary, tokenizer, device, use_kernels, output_dim)
        model.load_state_dict(sd, strict=True)
        models.append(model.to(device).eval())

    def _forward(feats):
        outs = [activation(m(**feats, outputs="logits")["logits"]) for m in models]
        return outs[0] if len(outs) == 1 else torch.stack(outs).mean(dim=0)

    def _embed(feats):
        # representations are per-model quantities: fold 0's ("train"
        # computes the same cls_repr and pooled as "all", without the pair
        # outputs)
        out = models[0](**feats, outputs="train")
        return out["cls_repr"], out["pooled"]

    return ResidentModel(models=models, forward=_forward, embed=_embed,
                         output_dim=output_dim, serve_folds=len(models))


def _build(cfg, task, dictionary, tokenizer, device, use_kernels, output_dim, group=None):
    """The served model of ``cfg`` (see resident_model), on the CPU."""
    unimol_overrides = dict(cfg.get("unimol_overrides") or {})
    unimol_overrides.setdefault(
        "pair_dtype", "bfloat16" if device.type == "cuda" else "float32"
    )
    return build_model(
        output_dim=output_dim,
        atom_vocab_size=len(dictionary),
        atom_pad_idx=dictionary.pad(),
        smiles_vocab_size=getattr(tokenizer, "vocab_size", 600),
        compute_dtype=cfg.get("compute_dtype", "bfloat16"),
        use_kernels=use_kernels,
        unimol_overrides=unimol_overrides,
        chemberta_overrides=chemberta_overrides(cfg) or None,
        crossmodal_overrides=dict(cfg.get("crossmodal_overrides") or {}) or None,
        task=task,
        use_fds=bool(cfg.get("fds", False)),
        fds_num=int(cfg.get("fds_num", 30) or 30),
        model_group=group,
    )


def _sharded_replica(cfg, state_dicts, task, dictionary, tokenizer, devices, use_kernels):
    """One tensor-parallel replica: shard i of the one fold's model on
    ``devices[i]``, the shards run in lockstep (ReplicaShards)."""
    if len(state_dicts) != 1:
        raise ValueError(TP_FOLDS_REFUSED)
    output_dim = resolve_output_dim(task, cfg.get("num_classes"), cfg.get("multiclass_cnt"))
    activation = ACTIVATION_REGISTRY[task]
    shards = ReplicaShards(devices)
    models = []
    for i, dev in enumerate(devices):
        model = _build(cfg, task, dictionary, tokenizer, devices[0], use_kernels, output_dim,
                       shards.handle(i))
        model.load_state_dict(shard_state_dict(state_dicts[0], i, shards.size), strict=True)
        models.append(model.to(dev).eval())

    def on_shards(fn, feats):
        # every shard reads the replica's inputs on its own device
        placed = [feats if dev == devices[0] else {k: v.to(dev) for k, v in feats.items()}
                  for dev in devices]
        return shards.run([lambda m=m, f=f: fn(m, f) for m, f in zip(models, placed)])[0]

    def _forward(feats):
        return on_shards(lambda m, f: activation(m(**f, outputs="logits")["logits"]), feats)

    def _embed(feats):
        def embed(m, f):
            out = m(**f, outputs="train")
            return out["cls_repr"], out["pooled"]
        return on_shards(embed, feats)

    return ResidentModel(models=models, forward=_forward, embed=_embed,
                         output_dim=output_dim, serve_folds=1)


def load_resident_model(
    load_model: str,
    cfg: Mapping[str, Any],
    task: str,
    dictionary,
    tokenizer,
    device: Union[str, torch.device, Sequence],
    use_kernels: bool = True,
    serve_folds: Union[str, int] = 1,
) -> ResidentModel:
    """The first ``serve_folds`` fold checkpoints of the experiment dir
    ``load_model`` (1, K or "all"), resident on ``device`` (a list of m
    devices: one tensor-parallel replica, which serves one fold)."""
    model_folds = int(cfg.get("model_folds", 1) or 1)
    k = model_folds if serve_folds == "all" else int(serve_folds)
    if isinstance(device, (list, tuple)) and k != 1:
        raise ValueError(TP_FOLDS_REFUSED)
    if k < 1 or k > model_folds:
        raise ValueError(
            f"serve_folds={serve_folds!r} but the experiment dir has "
            f"{model_folds} fold checkpoint(s)"
        )
    if model_folds > 1 and k == 1:
        logger.info(
            "experiment dir has %s fold checkpoints; serving fold 0 "
            "(pass serve_folds='all' for the ensemble, or use MolPredict "
            "for fold-averaged batch scoring)", model_folds,
        )
    state_dicts = [flax_params_to_state_dict(load_checkpoint(load_model, f)["params"])
                   for f in range(k)]
    if k > 1:
        logger.info("serving a %d-fold ensemble", k)
    return resident_model(cfg, state_dicts, task, dictionary, tokenizer, device, use_kernels)


def postprocess_predictions(
    task: str,
    raw: np.ndarray,
    scaler=None,
    threshold: Union[float, np.ndarray] = 0.5,
    multiclass_cnt: Optional[int] = None,
) -> dict:
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
