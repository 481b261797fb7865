"""MolTrain: the user-facing fit API (port of mmdti_tpu/api/train_api.py,
the ``fit(train, val)`` path).

The same keyword surface layered over the default config.  ``fit(train,
val)`` writes the experiment dir: config.yaml (configs/config.py's writer),
target_scaler.ss (data/scaler.py), model_0.ckpt (flax-msgpack,
train/checkpointing.py) and history_0.json, and keeps the inverse-scaled
validation predictions in ``cv_pred``.  ``fit(train)`` (k-fold CV) and the
classification tasks wait for later slices (ROADMAP.md, M5).  ``device``
is "cuda" unless the caller asks for the CPU; it is not written to the
config.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from mmdti_tpu_torch.configs.config import default_config, save_yaml
from mmdti_tpu_torch.data.hub import DataHub
from mmdti_tpu_torch.train.nnmodel import NNModel
from mmdti_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("mmdti_tpu_torch")


class MolTrain:
    def __init__(
        self,
        task: str = "classification",
        data_type: str = "molecule",
        epochs: int = 10,
        learning_rate: float = 1e-4,
        batch_size: int = 16,
        early_stopping: int = 5,
        metrics: str = "none",
        save_path: str = "./exp",
        remove_hs: bool = False,
        smiles_col: str = "SMILES",
        target_col_prefix: str = "TARGET",
        target_cols=None,
        target_anomaly_check: str = "filter",
        smiles_check: str = "filter",
        target_normalize: str = "auto",
        max_norm: float = 5.0,
        use_cuda: bool = True,
        use_amp: bool = True,
        model_name: str = "mm_model",
        chemberta_dir: str = "",
        unimol_dir: str = "",
        using_infonce: bool = False,
        using_ct: bool = False,
        cache_dir_train: Optional[str] = None,
        cache_dir_test: Optional[str] = None,
        use_weight: bool = False,
        all_weight: bool = False,
        alpha: float = 1,
        beta: float = 0.1,
        raw_data: Optional[str] = None,
        fds: bool = False,
        lds: bool = False,
        lds_kernel: str = "gaussian",
        lds_ks: int = 9,
        lds_sigma: float = 1.0,
        seed: int = 42,
        use_scaler: bool = True,
        fds_num: int = 200,
        fds_raw_path: str = "",
        fds_col_data: str = "",
        ct_lamda: float = 1.0,
        ct_w: float = 0.2,
        threshold_search: bool = False,
        kfold: int = 5,
        split: str = "random",
        split_group_col: str = "scaffold",
        device: str = "cuda",
        **params,
    ):
        config = default_config()
        config.task = task
        config.data_type = data_type
        config.epochs = epochs
        config.learning_rate = learning_rate
        config.batch_size = batch_size
        config.patience = early_stopping
        config.metrics = metrics
        config.remove_hs = remove_hs
        config.smiles_col = smiles_col
        config.target_col_prefix = target_col_prefix
        config.target_cols = target_cols
        config.anomaly_clean = target_anomaly_check in ["filter"]
        config.smi_strict = smiles_check in ["filter"]
        config.target_normalize = target_normalize
        config.max_norm = max_norm
        config.use_cuda = use_cuda
        config.use_amp = use_amp
        config.model_name = model_name
        config.chemberta_dir = chemberta_dir
        config.unimol_dir = unimol_dir
        config.using_ct = using_ct
        config.using_infonce = using_infonce
        config.cache_dir_train = cache_dir_train
        config.cache_dir_test = cache_dir_test
        config.use_weight = use_weight
        config.all_weight = all_weight
        config.alpha = alpha
        config.beta = beta
        config.raw_data = raw_data
        config.fds = fds
        config.lds = lds
        config.lds_kernel = lds_kernel
        config.lds_ks = lds_ks
        config.lds_sigma = lds_sigma
        config.seed = seed
        config.use_scaler = use_scaler
        config.fds_num = fds_num
        config.fds_raw_path = fds_raw_path
        config.fds_col_data = (
            fds_col_data if fds_col_data != "" else (target_cols[0] if target_cols else "")
        )
        config.ct_w = ct_w
        config.ct_lamda = ct_lamda
        config.threshold_search = threshold_search
        config.kfold = int(kfold)
        config.split = split
        config.split_group_col = split_group_col
        config.update_from(params)
        self.save_path = save_path
        self.config = config
        self.device = device

    def fit(self, data_train, data_val=None):
        """Fit one model (fold 0) on ``data_train`` against the held-out
        ``data_val`` (CSV paths, dicts of columns or tables)."""
        if data_val is None:
            raise NotImplementedError(
                "fit(data_train) runs k-fold cross-validation, which is not ported yet "
                "(ROADMAP.md, M5); pass data_val")
        self.datahub = DataHub(data=data_train, is_train=True, save_path=self.save_path,
                               **self.config)
        self.datahub_1 = DataHub(data=data_val, is_train=False, save_path=self.save_path,
                                 **self.config)
        self.data_train = self.datahub.data
        self.data_test = self.datahub_1.data
        self.update_and_save_config(n_folds=1)
        self.trainer = Trainer(save_path=self.save_path, device=self.device, **self.config)
        self.model = NNModel(self.data_train, self.data_test, self.trainer, **self.config)
        self.model.run()
        return self._finalize()

    def _finalize(self):
        """Inverse-scale the validation predictions into ``cv_pred``."""
        scaler = self.data_train["target_scaler"]
        y_pred = self.model.cv["pred"]
        if scaler is not None and scaler.scaler is not None:
            y_pred = scaler.inverse_transform(y_pred)
        self.cv_pred = np.asarray(y_pred)
        return self

    def update_and_save_config(self, n_folds: int = 1):
        self.config["num_classes"] = self.data_train["num_classes"]
        self.config["target_cols"] = ",".join(self.data_train["target_cols"])
        self.config["split_method"] = (
            f"{self.config.get('kfold', 5)}fold_{self.config.get('split', 'random')}")
        # the number of model_{fold} checkpoints the predict side averages
        self.config["model_folds"] = int(n_folds)
        if self.save_path is not None:
            os.makedirs(self.save_path, exist_ok=True)
            save_yaml(self.config, os.path.join(self.save_path, "config.yaml"))
