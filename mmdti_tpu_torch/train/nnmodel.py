"""Task-level model orchestration (port of mmdti_tpu/train/nnmodel.py).

Resolves the task's loss, activation and output width, builds the model
(models/mm_model.py::build_model) with the tokenizer and atom dictionary,
draws its initial weights, prepares the FDS state and buckets, and drives
Trainer.fit_predict (``run``) and the best-checkpoint predict
(``evaluate``, averaging fold checkpoints).  Pretrained Uni-Mol/ChemBERTa
ingestion, prefix freezing, k-fold CV and the GHM loss state wait for later
slices (ROADMAP.md, M5).

``use_pallas`` keeps the JAX config key: 'auto' or True builds the kernel
path (the Hopper kernels on a CUDA device, their plain versions on the
CPU), False the plain oracle path.  The threaded pair logits are bf16 on a
CUDA device and fp32 on the CPU unless ``unimol_overrides`` names a dtype.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmdti_tpu_torch.chem.dictionary import Dictionary
from mmdti_tpu_torch.chem.tokenizer import load_tokenizer
from mmdti_tpu_torch.data.batching import BatchCollator, MolDataset, dataset_pad_lengths
from mmdti_tpu_torch.data.reader import read_csv
from mmdti_tpu_torch.losses.fds import fds_bucket_params, fds_kernel_window, init_fds_state
from mmdti_tpu_torch.losses.registry import ACTIVATION_REGISTRY, resolve_loss, resolve_output_dim
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.trainer import Trainer, load_weights

logger = logging.getLogger("mmdti_tpu_torch")

_NOT_PORTED = ("unimol_dir", "chemberta_dir", "freeze_layers", "freeze_module")


class NNModel:
    def __init__(self, data_train: Dict[str, Any], data_test: Dict[str, Any], trainer: Trainer,
                 **params):
        for knob in _NOT_PORTED:
            if params.get(knob):
                raise NotImplementedError(f"{knob}={params[knob]!r} is not ported yet "
                                          "(ROADMAP.md, M5)")
        if params.get("data_type", "molecule") != "molecule":
            raise NotImplementedError("data_type='mof' is not ported yet (ROADMAP.md, M9)")
        self.data_train = data_train
        self.data_test = data_test
        self.trainer = trainer
        self.device = trainer.device
        self.task = params["task"]
        self.num_classes = data_train.get("num_classes")
        self.target_scaler = data_train.get("target_scaler")
        self.features_train = data_train["unimol_input"]
        self.features_test = data_test["unimol_input"]
        self.loss_key = params.get("loss_key", None)
        self.using_ct = params.get("using_ct", False)
        self.using_infonce = params.get("using_infonce", False)
        self.use_weight = params.get("use_weight", False)
        self.use_fds = params.get("fds", False)
        self.fds_num = params.get("fds_num", 30)
        self.save_path = trainer.save_path
        self.model_folds = int(params.get("model_folds", 1) or 1)
        self.cv: Dict[str, Any] = {}

        self.dictionary = Dictionary.load(None)
        self.dictionary.add_symbol("[MASK]", is_special=True)
        self.tokenizer = load_tokenizer(None)
        self.output_dim = resolve_output_dim(self.task, self.num_classes,
                                             data_train.get("multiclass_cnt"))
        self.loss_func = resolve_loss(self.task, self.loss_key)
        self.activation_fn = ACTIVATION_REGISTRY[self.task]

        pad_multiple = int(params.get("pad_multiple", 16))
        pad_mode = params.get("pad_mode", "dataset")
        if pad_mode == "fixed":
            def up(n):
                return int(-(-n // pad_multiple) * pad_multiple)

            self.atom_pad = up(int(params.get("max_atoms", 256)) + 2)
            self.smiles_pad = up(int(params.get("smiles_pad_len", 128)))
        else:
            self.atom_pad, self.smiles_pad = dataset_pad_lengths(
                self.features_train, self.tokenizer, pad_multiple,
                extra_datasets=[self.features_test])
        self.collator = BatchCollator(self.tokenizer, pad_idx=self.dictionary.pad(),
                                      pad_mode=pad_mode, atom_pad=self.atom_pad,
                                      smiles_pad=self.smiles_pad)

        use_kernels = params.get("use_pallas", "auto")
        use_kernels = True if use_kernels == "auto" else bool(use_kernels)
        unimol_overrides = dict(params.get("unimol_overrides") or {})
        unimol_overrides.setdefault(
            "pair_dtype", "bfloat16" if self.device.type == "cuda" else "float32")
        self.model = build_model(
            output_dim=self.output_dim,
            atom_vocab_size=len(self.dictionary),
            atom_pad_idx=self.dictionary.pad(),
            smiles_vocab_size=getattr(self.tokenizer, "vocab_size", 600),
            compute_dtype=params.get("compute_dtype", "bfloat16"),
            use_kernels=use_kernels,
            unimol_overrides=unimol_overrides,
            chemberta_overrides=dict(params.get("chemberta_overrides") or {}) or None,
            crossmodal_overrides=dict(params.get("crossmodal_overrides") or {}) or None,
            task=self.task,
            use_fds=self.use_fds,
            fds_num=self.fds_num,
        )
        if not params.get("evaluate_only"):
            self._init_params(params)
            n_params = sum(p.numel() for p in self.model.parameters())
            logger.info("Number of trainable parameters: %d", n_params)
        self.model.to(self.device)

        self.fds_state = None
        self.fds_bucket = (0.0, 1.0)
        self.fds_kernel = None
        if self.use_fds and self.task == "regression":
            raw_path = params.get("fds_raw_path", "") or params.get("raw_data", "")
            col = params.get("fds_col_data", "") or data_train["target_cols"][0]
            if raw_path and isinstance(raw_path, str) and os.path.exists(raw_path):
                raw_vals = np.asarray(read_csv(raw_path)[col], np.float64)
            else:
                raw_vals = np.asarray(data_train["raw_target"]).reshape(-1)
            self.fds_bucket = fds_bucket_params(raw_vals, self.fds_num,
                                                using_scale=params.get("use_scaler", True))
            cfg = self.model.fds_cfg
            self.fds_state = init_fds_state(cfg, self.device)
            self.fds_kernel = fds_kernel_window(cfg.kernel, cfg.ks, cfg.sigma)

    def _init_params(self, params) -> None:
        """Random initial weights, drawn as the flax initializers draw them,
        from the trainer's seed."""
        self.model.reset_parameters_like_flax(torch.Generator().manual_seed(self.trainer.seed))

    def run(self):
        logger.info("start training the MM-DTI model")
        y_train = np.asarray(self.data_train["target"])
        y_valid = np.asarray(self.data_test["target"])
        y_pred = self.trainer.fit_predict(
            self.model, MolDataset(self.features_train, y_train),
            MolDataset(self.features_test, y_valid), self.loss_func, self.activation_fn,
            self.save_path, 0, self.target_scaler, self.collator,
            use_infonce=self.using_infonce, use_ct=self.using_ct, use_weight=self.use_weight,
            fds_state=self.fds_state, fds_bucket=self.fds_bucket, fds_kernel=self.fds_kernel,
            fds_start_update=self.model.fds_cfg.start_update if self.fds_state is not None else 0,
        )
        self._log_fold_metric(0, y_valid, y_pred)
        self.cv["pred"] = y_pred
        return y_pred

    def _log_fold_metric(self, fold, y_true, y_pred) -> None:
        scaler = self.target_scaler
        if scaler is not None and scaler.scaler is not None:
            y_true, y_pred = scaler.inverse_transform(y_true), scaler.inverse_transform(y_pred)
        logger.info("fold %s, result %s", fold, self.trainer.metrics.cal_metric(y_true, y_pred))

    def evaluate(self, trainer: Optional[Trainer] = None,
                 checkpoints_path: Optional[str] = None):
        """Best-checkpoint predictions on the test features; a CV
        experiment (config model_folds > 1) averages every fold's."""
        logger.info("start predicting with the MM-DTI model")
        trainer = trainer or self.trainer
        dataset = MolDataset(self.features_test, np.asarray(self.data_test["target"]))
        fold_preds = []
        for fold in range(max(1, self.model_folds)):
            load_weights(self.model, checkpoints_path, fold)
            y_pred, _, _ = trainer.predict(self.model, dataset, self.activation_fn,
                                           self.target_scaler, self.collator,
                                           loss_fn=self.loss_func, skip_metrics=True)
            fold_preds.append(y_pred)
        y_pred = np.mean(np.stack(fold_preds), axis=0) if len(fold_preds) > 1 else fold_preds[0]
        self.cv["test_pred"] = y_pred
        return y_pred
