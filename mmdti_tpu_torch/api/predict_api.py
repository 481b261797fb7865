"""MolPredict: the user-facing inference API (port of
mmdti_tpu/api/predict_api.py).

Reads an experiment dir (config.yaml, target_scaler.ss, threshold.dat,
model_{fold}.ckpt for fold < model_folds), rebuilds the pipeline with
is_train=False, predicts with the best checkpoint(s), inverse-scales, and
writes ``<prefix>.predict.<run_id>.csv`` with the csv module: regression
adds ``predict_<col>``; binary and multilabel classification add
``prob_<col>`` and ``predict_<col>``, the probability cut at the stored
threshold; multiclass adds ``prob_0..prob_{c-1}`` and the argmax.  When
the input carries its targets (not the -1.0 placeholder) the probability
columns are scored into test_metric.result.  threshold.dat is read
without joblib: a standard pickle, or joblib's array format (the JAX
package's searched thresholds), through an unpickler that accepts numpy
arrays and scalars and nothing else (utils/joblib_pickle.py).  ``device``
is "cuda" unless the caller asks for the CPU.

A docking experiment (data_type "docking") returns, per complex, the
dict {"cross_distance": [n, p], "holo_distance": [n, n]} of its predicted
ligand-pocket and ligand-ligand distances over its n heavy atoms and p kept
pocket atoms (BOS and EOS left out), and with ``save_path`` writes them to
``<prefix>.predict.<run_id>.npz`` as cross_distance_<i> and
holo_distance_<i>.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from mmdti_tpu_torch.api.train_api import THRESHOLD_FILE
from mmdti_tpu_torch.configs.config import load_yaml
from mmdti_tpu_torch.data.batching import MolDataset
from mmdti_tpu_torch.data.hub import DataHub
from mmdti_tpu_torch.data.reader import write_csv
from mmdti_tpu_torch.train.nnmodel import NNModel
from mmdti_tpu_torch.train.trainer import Trainer
from mmdti_tpu_torch.utils.joblib_pickle import RestrictedUnpickler

logger = logging.getLogger("mmdti_tpu_torch")


def load_threshold(path: str):
    """The classification threshold(s) in ``path``: a float or an array
    with one per target column."""
    with open(path, "rb") as f:
        return RestrictedUnpickler(f, "threshold.dat").load()


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
                               device=self.device, **self.config)
        # the mesh a fit trained on is not this process's: predict takes
        # the default (its group's processes, or one)
        self.trainer = Trainer(save_path=self.load_model, device=self.device,
                               **{**self.config, "mesh_shape": None})
        cfg = dict(self.config)
        cfg["evaluate_only"] = True
        self.model = NNModel(self.datahub.data, self.datahub.data, self.trainer, **cfg)
        self.model.evaluate(self.trainer, self.load_model)

        y_pred = self.model.cv["test_pred"]
        if self.config.get("data_type") == "docking":
            return self._docking_predictions(np.asarray(y_pred), data, save_path)
        scaler = self.datahub.data["target_scaler"]
        if scaler is not None and scaler.scaler is not None:
            y_pred = scaler.inverse_transform(y_pred)
        y_pred = np.asarray(y_pred)

        table = dict(self.datahub.data["raw_data"])
        predict_cols = ["predict_" + col for col in self.target_cols]
        if self.task == "multiclass" and self.config.get("multiclass_cnt") is not None:
            prob_cols = ["prob_" + str(i) for i in range(self.config.multiclass_cnt)]
            table.update(zip(prob_cols, y_pred.T))
            table[predict_cols[0]] = np.argmax(y_pred, axis=1)
        elif self.task in ("classification", "multilabel_classification"):
            threshold = load_threshold(os.path.join(self.load_model, THRESHOLD_FILE))
            prob_cols = ["prob_" + col for col in self.target_cols]
            table.update(zip(prob_cols, y_pred.T))
            table.update(zip(predict_cols, (y_pred > threshold).astype(int).T))
        else:
            prob_cols = predict_cols
            table.update(zip(predict_cols, y_pred.T))
        truth = np.stack([np.asarray(table[c]) for c in self.target_cols], axis=1)
        if save_path:
            os.makedirs(save_path, exist_ok=True)
        if not (truth == -1.0).all():
            score = self.trainer.metrics.cal_metric(
                truth, np.stack([table[c] for c in prob_cols], axis=1))
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

    def _docking_predictions(self, y_pred: np.ndarray, data, save_path):
        """Each complex's predicted distances over its real atoms."""
        Np = self.model.pocket_pad
        out = []
        for f, pred in zip(self.datahub.data["unimol_input"], y_pred):
            n, p = len(f["src_tokens"]) - 2, len(f["pocket_src_tokens"]) - 2
            out.append({"cross_distance": pred[1:n + 1, 1:p + 1],
                        "holo_distance": pred[1:n + 1, Np + 1:Np + n + 1]})
        if save_path:
            prefix = data.split("/")[-1].split(".")[0] if isinstance(data, str) else "test"
            run_id = 0
            os.makedirs(save_path, exist_ok=True)
            while os.path.exists(os.path.join(save_path, f"{prefix}.predict.{run_id}.npz")):
                run_id += 1
            path = os.path.join(save_path, f"{prefix}.predict.{run_id}.npz")
            np.savez(path, **{f"{k}_{i}": v for i, d in enumerate(out) for k, v in d.items()})
            logger.info("save predict result to %s", path)
        return out

    def save_predict(self, table, out_dir: str, prefix: str) -> None:
        run_id = 0
        existing = set(os.listdir(out_dir)) if os.path.exists(out_dir) else set()
        os.makedirs(out_dir, exist_ok=True)
        while f"{prefix}.predict.{run_id}.csv" in existing:
            run_id += 1
        path = os.path.join(out_dir, f"{prefix}.predict.{run_id}.csv")
        write_csv(table, path, index=True)
        logger.info("save predict result to %s", path)
