"""MolTrain: the user-facing fit API (port of mmdti_tpu/api/train_api.py,
the ``fit(train, val)`` path).

The same keyword surface layered over the default config.  ``fit(train,
val)`` writes the experiment dir: config.yaml (configs/config.py's writer;
multiclass adds ``multiclass_cnt``), target_scaler.ss for the regression
tasks (data/scaler.py), threshold.dat for the binary and multilabel
classification tasks (0.5, or the per-column search on the validation
predictions with ``threshold_search=True``; a standard pickle, which
joblib.load reads too), model_0.ckpt (flax-msgpack,
train/checkpointing.py) and history_0.json, and keeps the inverse-scaled
validation predictions in ``cv_pred``.  ``fit(train)`` runs k-fold
cross-validation: ``kfold`` models on the folds of splits.Splitter
(``split``: random, scaffold, group or stratified), model_{fold}.ckpt and
history_{fold}.json each, ``model_folds: kfold`` in config.yaml, and the
out-of-fold predictions in ``cv_pred`` (the threshold search takes the
out-of-fold labels).  ``device`` is "cuda" unless the caller asks for the
CPU; it is not written to the config.

Data and tensor parallelism: run the same script in one process per
GPU, each in a torch.distributed group (``torchrun --nproc_per_node=N``,
or parallel/mesh.py::initialize_distributed before MolTrain);
``mesh_shape`` = (d, m) with d x m = N, by default (N, 1): d data ranks,
each row of m model ranks holding one shard of the model, and
``batch_size`` is the global batch.  Every rank fits, only rank 0 writes
the experiment dir (the single-writer rule; the checkpoint is the whole
model), and ``fit`` returns on every rank once the dir is whole.

``data_type="docking"`` fits Uni-Mol's binding-pose model
(models/docking.py) on protein-ligand complexes and takes the task
"docking" whatever ``task`` says: rows of a ligand SMILES and a pocket
``.npz`` with the ligand's holo pose (data/hub.py); no scaler, no
threshold; ``cv_pred`` holds the [n, Nm, Np + Nm] predicted distances.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from mmdti_tpu_torch.configs.config import default_config, save_yaml
from mmdti_tpu_torch.data.hub import DataHub
from mmdti_tpu_torch.parallel.mesh import barrier, is_writer_process
from mmdti_tpu_torch.splits import Splitter
from mmdti_tpu_torch.train.nnmodel import NNModel
from mmdti_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("mmdti_tpu_torch")

THRESHOLD_FILE = "threshold.dat"


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
        config.task = "docking" if data_type == "docking" else task
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
        """Fit on ``data_train`` (a CSV path, a dict of columns or a
        table): one model (fold 0) against ``data_val`` when it is given
        (``kfold`` then only names the split in the config), else k-fold
        cross-validation."""
        kfold = int(self.config.get("kfold", 5) or 1)
        if data_val is None:
            if kfold <= 1:
                raise ValueError(
                    "fit(data_train) without a validation set requires kfold > 1 for "
                    f"cross-validation (got kfold={kfold}); pass data_val for a single "
                    "train/val run")
            return self._fit_cv(data_train, kfold)
        self.datahub = DataHub(data=data_train, is_train=True, save_path=self.save_path,
                               device=self.device, **self.config)
        # the validation hub reads the scaler rank 0 has just written
        barrier()
        self.datahub_1 = DataHub(data=data_val, is_train=False, save_path=self.save_path,
                                 device=self.device, **self.config)
        self.data_train = self.datahub.data
        self.data_test = self.datahub_1.data
        self.update_and_save_config(n_folds=1)
        self.trainer = Trainer(save_path=self.save_path, device=self.device, **self.config)
        self.model = NNModel(self.data_train, self.data_test, self.trainer, **self.config)
        self.model.run()
        return self._finalize(np.asarray(self.data_test["target"], dtype=float))

    def _fit_cv(self, data_train, kfold: int):
        """Cross-validation: featurize and scale once, build one model whose
        initial weights every fold starts from, and fit the folds in turn."""
        self.datahub = DataHub(data=data_train, is_train=True, save_path=self.save_path,
                               device=self.device, **self.config)
        self.data_train = self.datahub.data
        self.data_test = self.data_train      # the pad lengths' source; folds slice it
        self.update_and_save_config(n_folds=kfold)
        self.trainer = Trainer(save_path=self.save_path, device=self.device, **self.config)
        self.model = NNModel(self.data_train, self.data_train, self.trainer, **self.config)
        self.model.run_cv(self._cv_splits(kfold))
        return self._finalize(np.asarray(self.data_train["target"], dtype=float))

    def _cv_splits(self, kfold: int):
        """The folds' (train, validation) index pairs: scaffold and group
        splits keep each group (the scaffolds of the SMILES, or the
        ``split_group_col`` column) in one fold, stratified splits balance
        the first target column's classes."""
        method = str(self.config.get("split", "random"))
        splitter = Splitter(f"{kfold}fold_{method}", seed=int(self.config.get("seed", 42)))
        target = np.asarray(self.data_train["target"])
        idx = np.arange(target.shape[0])
        if method in ("scaffold", "group"):
            group = self.data_train.get("group")
            if group is None:
                raise ValueError(
                    f"split='{method}' needs group labels: provide the "
                    f"'{self.config.get('split_group_col', 'scaffold')}' column or SMILES "
                    "input (scaffolds are derived from it)")
            return splitter.split(idx, group=np.asarray(group))
        if method == "stratified":
            return splitter.split(idx, target=target[:, 0].astype(int))
        return splitter.split(idx)

    def _finalize(self, val_true: np.ndarray):
        """Inverse-scale the predictions into ``cv_pred``; write
        threshold.dat for the thresholded tasks, searched against
        ``val_true`` (the labels the predictions align with: the
        validation set's, or the whole train set's out of fold)."""
        scaler = self.data_train["target_scaler"]
        y_pred = self.model.cv["pred"]
        if scaler is not None and scaler.scaler is not None:
            y_pred = scaler.inverse_transform(y_pred)
        if self.config["task"] in ("classification", "multilabel_classification"):
            threshold = 0.5
            if self.config.get("threshold_search"):
                threshold = self.trainer.metrics.search_threshold(
                    val_true, np.asarray(self.model.cv["pred"], dtype=float))
                logger.info("Searched classification thresholds: %s", threshold)
            if is_writer_process():
                with open(os.path.join(self.save_path, THRESHOLD_FILE), "wb") as f:
                    pickle.dump(threshold, f, protocol=4)
        self.cv_pred = np.asarray(y_pred)
        # every rank returns once rank 0's artifacts are written
        barrier()
        return self

    def update_and_save_config(self, n_folds: int = 1):
        self.config["num_classes"] = self.data_train["num_classes"]
        self.config["target_cols"] = ",".join(self.data_train["target_cols"])
        if self.config["task"] == "multiclass":
            self.config["multiclass_cnt"] = self.data_train["multiclass_cnt"]
        self.config["split_method"] = (
            f"{self.config.get('kfold', 5)}fold_{self.config.get('split', 'random')}")
        # the number of model_{fold} checkpoints the predict side averages
        self.config["model_folds"] = int(n_folds)
        if self.save_path is not None and is_writer_process():
            os.makedirs(self.save_path, exist_ok=True)
            save_yaml(self.config, os.path.join(self.save_path, "config.yaml"))
