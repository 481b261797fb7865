"""MolPredict: the user-facing inference API (port of
mmdti_tpu/api/predict_api.py for the regression tasks).

Reads an experiment dir (config.yaml, target_scaler.ss, model_{fold}.ckpt
for fold < model_folds), rebuilds the pipeline with is_train=False,
predicts with the best checkpoint(s), inverse-scales, scores the
predictions when the input carries its targets (not the -1.0 placeholder)
and writes ``<prefix>.predict.<run_id>.csv`` with the csv module.
``device`` is "cuda" unless the caller asks for the CPU.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from mmdti_tpu_torch.configs.config import load_yaml
from mmdti_tpu_torch.data.batching import MolDataset
from mmdti_tpu_torch.data.hub import DataHub
from mmdti_tpu_torch.data.reader import write_csv
from mmdti_tpu_torch.train.nnmodel import NNModel
from mmdti_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("mmdti_tpu_torch")


class MolPredict:
    def __init__(self, load_model: Optional[str] = None, cache_dir: Optional[str] = None,
                 extract_feature: bool = False, device: str = "cuda"):
        if not load_model:
            raise ValueError("load_model is empty")
        self.load_model = load_model
        self.config = load_yaml(os.path.join(load_model, "config.yaml"))
        self.config.target_cols = str(self.config.target_cols).split(",")
        self.task = self.config.task
        self.config.cache_dir_test = cache_dir
        self.target_cols = self.config.target_cols
        self.extract_feature = extract_feature
        self.device = device

    def predict(self, data, save_path: Optional[str] = None, metrics: str = "none"):
        self.save_path = save_path
        if metrics and metrics != "none":
            self.config.metrics = metrics
        self.datahub = DataHub(data=data, is_train=False, save_path=self.load_model,
                               **self.config)
        self.trainer = Trainer(save_path=self.load_model, device=self.device, **self.config)
        cfg = dict(self.config)
        cfg["evaluate_only"] = True
        self.model = NNModel(self.datahub.data, self.datahub.data, self.trainer, **cfg)
        self.model.evaluate(self.trainer, self.load_model)

        y_pred = self.model.cv["test_pred"]
        scaler = self.datahub.data["target_scaler"]
        if scaler is not None and scaler.scaler is not None:
            y_pred = scaler.inverse_transform(y_pred)
        y_pred = np.asarray(y_pred)

        table = dict(self.datahub.data["raw_data"])
        predict_cols = ["predict_" + col for col in self.target_cols]
        for j, col in enumerate(predict_cols):
            table[col] = y_pred[:, j]
        truth = np.stack([np.asarray(table[c], np.float64) for c in self.target_cols], axis=1)
        if save_path:
            os.makedirs(save_path, exist_ok=True)
        if not (truth == -1.0).all():
            score = self.trainer.metrics.cal_metric(truth, y_pred)
            logger.info("final predict metrics score: \n%s", score)
            if save_path:
                # a plain pickle of the score dict, which joblib.load also reads
                with open(os.path.join(save_path, "test_metric.result"), "wb") as f:
                    pickle.dump(score, f)
        else:
            for col in self.target_cols:
                del table[col]
        if save_path:
            prefix = data.split("/")[-1].split(".")[0] if isinstance(data, str) else "test"
            self.save_predict(table, save_path, prefix)
        if self.extract_feature:
            dataset = MolDataset(self.datahub.data["unimol_input"],
                                 np.asarray(self.datahub.data["target"]))
            self.cv_repr = self.trainer.inference(
                self.model.model, dataset, self.model.collator, return_atomic_reprs=True,
                dictionary=self.model.dictionary)
        return y_pred

    def save_predict(self, table, out_dir: str, prefix: str) -> None:
        run_id = 0
        existing = set(os.listdir(out_dir)) if os.path.exists(out_dir) else set()
        os.makedirs(out_dir, exist_ok=True)
        while f"{prefix}.predict.{run_id}.csv" in existing:
            run_id += 1
        path = os.path.join(out_dir, f"{prefix}.predict.{run_id}.csv")
        write_csv(table, path, index=True)
        logger.info("save predict result to %s", path)
