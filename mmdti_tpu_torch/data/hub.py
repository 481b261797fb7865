"""DataHub: host-side data preparation (port of mmdti_tpu/data/hub.py
without the MOF branch).

Reads a CSV path, a dict of columns, a table or a SMILES list; fits the
target scaler on the ``raw_data`` CSV's targets when one is given (else on
this split's), applies it; computes ConR sample weights; featurizes the
molecules with the host conformer provider (chem/conformer.py), cached in a
pickle keyed by the featurizer fingerprint; and attaches each sample's
SMILES and weight to its feature dict.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.dictionary import Dictionary
from mmdti_tpu_torch.data.reader import MolDataReader, read_csv
from mmdti_tpu_torch.data.scaler import TargetScaler
from mmdti_tpu_torch.data.weights import compute_sample_weights

logger = logging.getLogger("mmdti_tpu_torch")


def _coord_provider(params: Dict[str, Any]) -> str:
    """The port featurizes on the host only; 'auto' resolves to it."""
    provider = params.get("coord_provider", "auto") or "auto"
    if provider not in ("auto", "host"):
        raise NotImplementedError(
            f"coord_provider={provider!r}: the device conformer provider is not ported "
            "yet (ROADMAP.md, M10)"
        )
    return "host"


def _featurizer_fingerprint(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every knob that changes ConformerGen's output, with the dictionary
    (the JAX package's fingerprint for a molecule cache on the host)."""
    dict_path = params.get("dict_path", None)
    unimol_dir = params.get("unimol_dir", "") or ""
    if dict_path is None and unimol_dir:
        cand = os.path.join(os.path.dirname(unimol_dir), "mol.dict.txt")
        dict_path = cand if os.path.exists(cand) else None
    d = Dictionary.load(dict_path)
    d.add_symbol("[MASK]", is_special=True)
    return {
        "featurizer_rev": 2,
        "seed": params.get("seed", 42),
        "max_atoms": params.get("max_atoms", 256),
        "data_type": params.get("data_type", "molecule"),
        "method": params.get("method", "rdkit_random"),
        "mode": params.get("mode", "fast"),
        "remove_hs": bool(params.get("remove_hs", False)),
        "pair_feats": bool(params.get("pair_feats", True)),
        "coord_provider": _coord_provider(params),
        "dict": hashlib.md5("\n".join(d.symbols).encode()).hexdigest(),
    }


class DataHub:
    def __init__(self, data=None, is_train: bool = True, save_path: Optional[str] = None,
                 **params):
        if params.get("data_type", "molecule") != "molecule":
            raise NotImplementedError("data_type='mof' is not ported yet (ROADMAP.md, M9)")
        self.data: Dict[str, Any] = {}
        self.is_train = is_train
        self.save_path = save_path
        self.task = params.get("task", None)
        self.cache_dir_train = params.get("cache_dir_train", None)
        self.cache_dir_test = params.get("cache_dir_test", None)
        self.ss_method = params.get("target_normalize", "none")
        self.all_weight = params.get("all_weight", False)
        self.raw_data = params.get("raw_data", None)
        self.lds = params.get("lds", False)
        self.lds_kernel = params.get("lds_kernel", "gaussian")
        self.lds_ks = int(params.get("lds_ks", 9))
        self.lds_sigma = float(params.get("lds_sigma", 1.0))
        self.use_scaler = params.get("use_scaler", True)
        self.max_bin = params.get("fds_num", 200)
        self.use_weight = params.get("use_weight", False)
        self._init_data(data, **params)

    def _scaler_fit_source(self, fallback: np.ndarray) -> np.ndarray:
        """Targets that fit the scaler: the raw training CSV when given,
        else this split's targets."""
        if self.raw_data and isinstance(self.raw_data, str) and os.path.exists(self.raw_data):
            table = read_csv(self.raw_data)
            return np.stack([np.asarray(table[c], np.float64)
                             for c in self.data["target_cols"]], axis=1)
        return fallback

    def _init_data(self, data, **params) -> None:
        self.data = MolDataReader().read_data(data, self.is_train, **params)
        task = self.task
        num_classes = self.data.get("num_classes")
        scaler = TargetScaler(self.ss_method, task, self.save_path) if self.use_scaler else None
        self.data["target_scaler"] = scaler

        raw_target = self.data["raw_target"]
        if task in ("regression", "multilabel_regression"):
            width = 1 if task == "regression" else num_classes
            target = np.array(raw_target, dtype=np.float32).reshape(-1, width)
            if scaler is not None:
                # training always refits; predict keeps the loaded artifact
                if self.is_train:
                    scaler.fit(self._scaler_fit_source(target), self.save_path)
                    logger.info("Fitted target scaler.")
                target = scaler.transform(target)
            self.data["target"] = np.asarray(target, dtype=np.float32)
        elif task in ("classification", "multiclass", "multilabel_classification"):
            raise NotImplementedError(
                f"task={task!r} is not ported yet (ROADMAP.md, M5); the port trains "
                "regression and multilabel_regression"
            )
        elif task == "repr":
            self.data["target"] = raw_target
        else:
            raise ValueError(f"Unknown task: {task}")

        if self.use_weight and task != "repr":
            self.data["weights"] = compute_sample_weights(
                self.data["target"], all_weight=self.all_weight, lds=self.lds,
                max_bin=self.max_bin, lds_kernel=self.lds_kernel,
                lds_ks=self.lds_ks, lds_sigma=self.lds_sigma,
            )
            logger.info("Computed %s sample weights.",
                        "per-column" if self.all_weight else "single-column")
        else:
            if task != "repr":
                tgt = np.asarray(self.data["target"])
            else:
                tgt = np.zeros((len(self.data["smiles"] or self.data.get("atoms") or []), 1))
            self.data["weights"] = np.ones_like(tgt, dtype=np.float32)

        # conformer features, cached by fingerprint
        cache_dir = self.cache_dir_train if self.is_train else self.cache_dir_test
        fingerprint = _featurizer_fingerprint(params)
        features = None
        if cache_dir is not None and os.path.exists(cache_dir):
            with open(cache_dir, "rb") as f:
                cached = pickle.load(f)
            if isinstance(cached, dict) and cached.get("fingerprint") == fingerprint:
                features = cached["features"]
                logger.info("Loaded conformer features from cache %s", cache_dir)
            else:
                logger.warning("Conformer cache %s was built with other featurizer "
                               "params; regenerating.", cache_dir)
        if features is None:
            gen = ConformerGen(**{**params, "coord_provider": fingerprint["coord_provider"]})
            if "atoms" in self.data and "coordinates" in self.data:
                features = gen.transform_raw(self.data["atoms"], self.data["coordinates"])
            else:
                features = gen.transform(self.data["smiles"])
            if cache_dir is not None:
                os.makedirs(os.path.dirname(os.path.abspath(cache_dir)), exist_ok=True)
                with open(cache_dir, "wb") as f:
                    pickle.dump({"fingerprint": fingerprint, "features": features}, f)
                logger.info("Saved conformer features to cache %s", cache_dir)

        weights = np.asarray(self.data["weights"])
        smiles = self.data.get("smiles")
        for idx, item in enumerate(features):
            if smiles is not None:
                item["smile"] = smiles[idx]
            item["weights"] = weights[idx] if weights.ndim > 0 else weights
        self.data["unimol_input"] = features
