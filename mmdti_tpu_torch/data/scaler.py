"""Target scaling (port of mmdti_tpu/data/scaler.py) in numpy.

Regression and multilabel regression with ``standard`` (scikit-learn's
StandardScaler: mean and the ddof-0 std), ``robust`` (RobustScaler: median
and the 25-75 interquantile range) and ``auto`` (robust when |skew| > 5 or
|kurtosis| > 20, else standard; scipy).  A zero scale becomes 1, as in
scikit-learn.  The other scikit-learn modes of the JAX package raise until
a later slice ports them (ROADMAP.md, M5).

The fitted numbers persist as ``target_scaler.ss`` in the experiment dir,
an ``.npz`` archive (method names, centers, scales; one row per target
column).  The JAX package writes a joblib pickle under the same name, which
this module does not read.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from scipy.stats import kurtosis, skew

logger = logging.getLogger("mmdti_tpu_torch")

_CLS_TASKS = ("classification", "multiclass", "multilabel_classification")
ARTIFACT_NAME = "target_scaler.ss"
PORTED_MODES = ("standard", "robust")


@dataclass
class ColumnScaler:
    """x -> (x - center) / scale for one target column."""

    method: str
    center: float
    scale: float

    @classmethod
    def fit(cls, method: str, values: np.ndarray) -> "ColumnScaler":
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if method == "standard":
            center, scale = v.mean(), v.std()
        elif method == "robust":
            center = np.nanmedian(v)
            q25, q75 = np.nanpercentile(v, (25.0, 75.0))
            scale = q75 - q25
        else:
            raise NotImplementedError(
                f"target_normalize={method!r} is not ported yet (ROADMAP.md, M5); "
                f"the port has {PORTED_MODES} and 'auto'"
            )
        # scikit-learn's _handle_zeros_in_scale
        if scale < 10 * np.finfo(np.float64).eps:
            scale = 1.0
        return cls(method, float(center), float(scale))

    def transform(self, x):
        return (np.asarray(x, dtype=np.float64) - self.center) / self.scale

    def inverse_transform(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale + self.center


class TargetScaler:
    def __init__(self, ss_method: str, task: str, load_dir: Optional[str] = None):
        self.ss_method = ss_method
        self.task = task
        self.scaler: Optional[List[ColumnScaler]] = None
        if load_dir and os.path.exists(os.path.join(load_dir, ARTIFACT_NAME)):
            self.scaler = load_scaler(os.path.join(load_dir, ARTIFACT_NAME))

    def is_skewed(self, target) -> bool:
        if self.task in _CLS_TASKS:
            return False
        t = np.asarray(target, dtype=np.float64).reshape(-1)
        t = t[~np.isnan(t)]
        return abs(skew(t)) > 5.0 or abs(kurtosis(t)) > 20.0

    def _method(self, values) -> str:
        if self.ss_method != "auto":
            return self.ss_method
        method = "robust" if self.is_skewed(values) else "standard"
        logger.info("Auto selected %s transformer.", method)
        return method

    def fit(self, target, dump_dir: Optional[str] = None) -> None:
        if self.task in _CLS_TASKS or self.ss_method == "none":
            return
        target = np.asarray(target, dtype=np.float64)
        if target.ndim == 1:
            target = target.reshape(-1, 1)
        if self.task == "regression":
            self.scaler = [ColumnScaler.fit(self._method(target), target)]
        elif self.task == "multilabel_regression":
            self.scaler = []
            for i in range(target.shape[1]):
                col = target[:, i]
                valid = col[~np.isnan(col)]
                self.scaler.append(ColumnScaler.fit(self._method(valid), valid))
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            save_scaler(self.scaler, os.path.join(dump_dir, ARTIFACT_NAME))

    def transform(self, target):
        if self.task in _CLS_TASKS or self.ss_method == "none" or self.scaler is None:
            return target
        target = np.asarray(target, dtype=np.float64)
        if self.task == "regression":
            return self.scaler[0].transform(target)
        if self.task == "multilabel_regression":
            out = np.array(target, dtype=np.float64)
            for i, sc in enumerate(self.scaler):
                mask = ~np.isnan(target[:, i])
                out[mask, i] = sc.transform(target[mask, i])
            return out
        return target

    def inverse_transform(self, target):
        if self.task in _CLS_TASKS or self.ss_method == "none" or self.scaler is None:
            return target
        target = np.asarray(target, dtype=np.float64)
        if self.task == "regression":
            return self.scaler[0].inverse_transform(target)
        if self.task == "multilabel_regression":
            out = np.zeros_like(target)
            for i, sc in enumerate(self.scaler):
                out[:, i] = sc.inverse_transform(target[:, i])
            return out
        raise ValueError(f"Unknown scaler method: {self.ss_method}")


def save_scaler(columns: List[ColumnScaler], path: str) -> None:
    with open(path, "wb") as f:
        np.savez(f, method=np.asarray([c.method for c in columns]),
                 center=np.asarray([c.center for c in columns], np.float64),
                 scale=np.asarray([c.scale for c in columns], np.float64))


def load_scaler(path: str) -> List[ColumnScaler]:
    try:
        with np.load(path, allow_pickle=False) as z:
            return [ColumnScaler(str(m), float(c), float(s))
                    for m, c, s in zip(z["method"], z["center"], z["scale"])]
    except (ValueError, KeyError, OSError) as e:
        raise ValueError(
            f"{path} is not a scaler this package wrote (an .npz archive); reading the "
            "JAX package's joblib scaler is not ported yet (ROADMAP.md, M5)"
        ) from e
