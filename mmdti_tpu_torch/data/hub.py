"""DataHub: host-side data preparation (port of mmdti_tpu/data/hub.py).

Reads a CSV path, a dict of columns, a table or a SMILES list; shapes the
targets by task (regression: scaled float32; classification and
multiclass: int32 [n, 1], with the config's multiclass_cnt at predict
time; multilabel classification: float32 that keeps NaN); fits the
target scaler on the ``raw_data`` CSV's targets when one is given (else on
this split's), applies it; computes ConR sample weights; featurizes the
molecules with the resolved conformer provider (chem/conformer.py: 'auto'
is 'device' when ``device``, the entry point's, is a CUDA device), cached
in a pickle keyed by the featurizer fingerprint; and attaches each sample's
SMILES and weight to its feature dict.  With ``data_type='mof'`` each row
names a CIF crystal and a gas instead (``_featurize_mof``).  With
``data_type='docking'`` each row is a protein-ligand complex
(``_init_docking``): the ligand's SMILES, and an ``.npz`` with the
pocket's atoms and coordinates and, to train on, the ligand's holo pose.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from mmdti_tpu_torch.chem.conformer import ConformerGen, resolve_coord_provider
from mmdti_tpu_torch.chem.dictionary import Dictionary, unimol_dict_path
from mmdti_tpu_torch.chem.mof import MOFReader
from mmdti_tpu_torch.chem.pocket import (
    MAX_POCKET_ATOMS,
    docking_targets,
    pocket_dictionary,
    pocket_features,
)
from mmdti_tpu_torch.data.reader import MolDataReader, read_csv
from mmdti_tpu_torch.data.scaler import TargetScaler
from mmdti_tpu_torch.data.weights import compute_sample_weights
from mmdti_tpu_torch.parallel.mesh import is_writer_process

logger = logging.getLogger("mmdti_tpu_torch")


def _featurizer_fingerprint(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every knob that changes ConformerGen's output, with the dictionary:
    the JAX package's fingerprint for the same parameters.  The provider
    is the resolved one (``device`` decides 'auto'), and the device
    provider's size threshold counts only where that provider runs."""
    dict_path = params.get("dict_path", None)
    if dict_path is None:
        dict_path = unimol_dict_path(params.get("unimol_dir"))
    d = Dictionary.load(dict_path)
    d.add_symbol("[MASK]", is_special=True)
    # MOF features rev 2: the crop past max_atoms is seeded by the crystal's
    # content (molecule caches carry no such key)
    extra = {"mof_rev": 2} if params.get("data_type", "molecule") == "mof" else {}
    provider = resolve_coord_provider(params.get("coord_provider", "auto"),
                                      params.get("device"))
    if provider == "device":
        extra["device_refine_min_atoms"] = int(params.get("device_refine_min_atoms", 48))
    return {
        **extra,
        "featurizer_rev": 2,
        "seed": params.get("seed", 42),
        "max_atoms": params.get("max_atoms", 256),
        "data_type": params.get("data_type", "molecule"),
        "method": params.get("method", "rdkit_random"),
        "mode": params.get("mode", "fast"),
        "remove_hs": bool(params.get("remove_hs", False)),
        "pair_feats": bool(params.get("pair_feats", True)),
        "coord_provider": provider,
        "dict": hashlib.md5("\n".join(d.symbols).encode()).hexdigest(),
    }


class DataHub:
    def __init__(self, data=None, is_train: bool = True, save_path: Optional[str] = None,
                 **params):
        self.data: Dict[str, Any] = {}
        self.is_train = is_train
        self.save_path = save_path
        self.task = params.get("task", None)
        self.multiclass_cnt = params.get("multiclass_cnt", None)
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

    def _featurize_mof(self, params: Dict[str, Any], source):
        """MOF rows -> coords2unimol_mof features with gas_id, gas_attr,
        pressure and temperature (chem/mof.py).  Each row has a CIF path
        (column ``cif_col``, default 'cif'; a relative path that does not
        exist as it stands resolves against the directory of the CSV
        ``source``), a gas of chem.mof.GAS_LIST (``gas_col``, default
        'gas'), and optional 'pressure' and 'temperature' columns (1.0 and
        298.0 where a column is absent).  The atom dictionary is
        ``dict_path``, else the mol.dict.txt beside ``unimol_dir``."""
        table = self.data["raw_data"]
        cif_col = params.get("cif_col", "cif")
        gas_col = params.get("gas_col", "gas")
        for col in (cif_col, gas_col):
            if col not in table:
                raise ValueError(
                    f"data_type='mof' requires a {col!r} column; got {list(table)}")
        dict_path = params.get("dict_path", None)
        if dict_path is None:
            dict_path = unimol_dict_path(params.get("unimol_dir"))
        reader = MOFReader(dict_path=dict_path, max_atoms=int(params.get("max_atoms", 512)),
                           seed=int(params.get("seed", 42)))
        base = ""
        if source and os.path.exists(source):
            base = os.path.dirname(os.path.abspath(source))
        features = []
        for i in range(len(table[cif_col])):
            cif = str(table[cif_col][i])
            if base and not os.path.isabs(cif) and not os.path.exists(cif):
                cif = os.path.join(base, cif)
            feat = reader.read_with_gas(cif, str(table[gas_col][i]))
            feat["pressure"] = float(table["pressure"][i]) if "pressure" in table else 1.0
            feat["temperature"] = (float(table["temperature"][i]) if "temperature" in table
                                   else 298.0)
            features.append(feat)
        logger.info("Featurized %d MOF samples from CIF files.", len(features))
        return features

    def _init_docking(self, data, source, **params) -> None:
        """Docking rows: the ligand's SMILES (``smiles_col``) and an ``.npz``
        (column ``pocket_col``, default 'pocket'; a relative path resolves
        against the CSV's directory, as MOF CIF paths do) holding
        ``pocket_atoms`` (element symbols), ``pocket_coord`` [p, 3] and,
        for training, ``holo_coord`` [n, 3]: the ligand's holo heavy-atom
        coordinates in the SMILES' heavy-atom order.  The ligand's input
        conformer is the featurizer's (chem/conformer.py), hydrogens
        removed; the pocket is cropped at ``max_pocket_atoms``
        (chem/pocket.py).  Each feature dict gets the pocket's tokens and
        coordinates and the distance targets (zero without a holo pose);
        the padded label arrays are made where the pads are known
        (train/nnmodel.py).  No conformer cache is read or written."""
        self.data = MolDataReader().read_data(data, self.is_train, **{**params, "task": "repr"})
        self.data.update(target_scaler=None, target_cols=[], num_classes=None, raw_target=None)
        table = self.data["raw_data"]
        col = params.get("pocket_col", "pocket")
        if col not in table:
            raise ValueError(f"data_type='docking' requires a {col!r} column; got {list(table)}")
        base = os.path.dirname(os.path.abspath(source)) if source and os.path.exists(source) \
            else ""
        provider = resolve_coord_provider(params.get("coord_provider", "auto"),
                                          params.get("device"))
        gen = ConformerGen(**{**params, "remove_hs": True, "coord_provider": provider})
        ligands = gen.transform(self.data["smiles"])
        pdict = pocket_dictionary(params.get("pocket_dict_path"))
        max_pocket = int(params.get("max_pocket_atoms", MAX_POCKET_ATOMS))
        features = []
        for i, lig in enumerate(ligands):
            path = str(table[col][i])
            if base and not os.path.isabs(path) and not os.path.exists(path):
                path = os.path.join(base, path)
            with np.load(path) as z:
                pocket = pocket_features(z["pocket_atoms"], z["pocket_coord"], pdict, max_pocket)
                holo = np.asarray(z["holo_coord"], np.float32) if "holo_coord" in z else None
            n = len(lig["src_tokens"]) - 2
            if holo is None and self.is_train:
                raise ValueError(f"{path}: a training complex needs holo_coord")
            if holo is not None and len(holo) != n:
                raise ValueError(f"{path}: holo_coord has {len(holo)} atoms and the ligand "
                                 f"{self.data['smiles'][i]!r} {n} heavy atoms")
            targets = docking_targets(np.zeros((n, 3)) if holo is None else holo,
                                      pocket["pocket_coord"])
            if holo is None:
                targets = {k: np.zeros_like(v) for k, v in targets.items()}
            features.append({**lig, "pocket_src_tokens": pocket["pocket_src_tokens"],
                             "pocket_src_coord": pocket["pocket_src_coord"], **targets,
                             "weights": np.ones(1, np.float32)})
        logger.info("Featurized %d docking complexes.", len(features))
        self.data["target"] = np.zeros((len(features), 1), np.float32)
        self.data["weights"] = np.ones((len(features), 1), np.float32)
        self.data["unimol_input"] = features

    def _init_data(self, data, **params) -> None:
        # a CSV path: relative CIF paths of a MOF dataset resolve against it
        source = data if isinstance(data, str) else (
            self.raw_data if isinstance(self.raw_data, str) else None)
        if params.get("data_type", "molecule") == "docking":
            self._init_docking(data, source, **params)
            return
        self.data = MolDataReader().read_data(data, self.is_train, **params)
        task = self.task
        num_classes = self.data.get("num_classes")
        # a training hub refits the scaler, so it reads no earlier artifact:
        # under a data-parallel group rank 0 may be rewriting that file
        scaler = (TargetScaler(self.ss_method, task, None if self.is_train else self.save_path)
                  if self.use_scaler else None)
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
        elif task in ("classification", "multiclass"):
            self.data["target"] = np.array(raw_target, dtype=np.int32).reshape(-1, 1)
            if task == "multiclass" and not self.is_train:
                self.data["multiclass_cnt"] = self.multiclass_cnt
        elif task == "multilabel_classification":
            # float32 that keeps NaN: a missing label masks out of the losses
            # and the column-averaged metrics (an int cast would destroy it)
            self.data["target"] = np.array(raw_target, dtype=np.float32).reshape(-1, num_classes)
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
            if params.get("data_type", "molecule") == "mof":
                features = self._featurize_mof(params, source)
            else:
                gen = ConformerGen(**{**params, "coord_provider": fingerprint["coord_provider"]})
                if "atoms" in self.data and "coordinates" in self.data:
                    features = gen.transform_raw(self.data["atoms"], self.data["coordinates"])
                else:
                    features = gen.transform(self.data["smiles"])
            if cache_dir is not None and is_writer_process():
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
