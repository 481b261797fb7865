"""Target scaling (port of mmdti_tpu/data/scaler.py) in numpy.

Regression and multilabel regression with ``standard`` (scikit-learn's
StandardScaler: mean and the ddof-0 std), ``robust`` (RobustScaler: median
and the 25-75 interquantile range) and ``auto`` (robust when |skew| > 5 or
|kurtosis| > 20, else standard; scipy).  A zero scale becomes 1, as in
scikit-learn.  The other scikit-learn modes of the JAX package raise until
a later slice ports them (ROADMAP.md, M5).

The fitted numbers persist as ``target_scaler.ss`` in the experiment dir,
in the JAX package's format: the pickle ``joblib.dump`` writes of a fitted
scikit-learn StandardScaler or RobustScaler (a list of them, one per
column, for multilabel_regression), written and read here without either
package (utils/joblib_pickle.py).  The stand-in classes below carry the
fitted attributes scikit-learn pickles, under scikit-learn's class names;
a scaler of another class raises.  The ``.npz`` archive earlier versions
of this package wrote is still read (a zip: its first bytes are ``PK``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from scipy.stats import kurtosis, skew

from mmdti_tpu_torch.parallel.mesh import is_writer_process
from mmdti_tpu_torch.utils.joblib_pickle import GlobalPickler, RestrictedUnpickler

logger = logging.getLogger("mmdti_tpu_torch")

_CLS_TASKS = ("classification", "multiclass", "multilabel_classification")
ARTIFACT_NAME = "target_scaler.ss"
PORTED_MODES = ("standard", "robust")


@dataclass
class ColumnScaler:
    """x -> (x - center) / scale for one target column; a standard one
    also keeps the variance and the sample count scikit-learn stores."""

    method: str
    center: float
    scale: float
    var: Optional[float] = None
    n_samples: int = 0

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
        var = float(v.var()) if method == "standard" else None
        # scikit-learn's _handle_zeros_in_scale
        if scale < 10 * np.finfo(np.float64).eps:
            scale = 1.0
        return cls(method, float(center), float(scale), var, int(v.size))

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
        if dump_dir and is_writer_process():      # rank 0 writes (parallel/mesh.py)
            os.makedirs(dump_dir, exist_ok=True)
            save_scaler(self.scaler, os.path.join(dump_dir, ARTIFACT_NAME),
                        as_list=self.task == "multilabel_regression")

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


_SKLEARN_MODULE = "sklearn.preprocessing._data"


class _StandardScaler:
    """scikit-learn's StandardScaler as its pickle holds it: the
    constructor's options and the fitted attributes, one column."""

    @classmethod
    def of(cls, col: ColumnScaler) -> "_StandardScaler":
        out = cls()
        out.__dict__.update(
            with_mean=True, with_std=True, copy=True, n_features_in_=1,
            n_samples_seen_=np.int64(col.n_samples), mean_=np.asarray([col.center], np.float64),
            var_=np.asarray([col.scale ** 2 if col.var is None else col.var], np.float64),
            scale_=np.asarray([col.scale], np.float64))
        return out

    def columns(self) -> List[ColumnScaler]:
        n = int(getattr(self, "n_features_in_", 1))
        center = self.mean_ if self.with_mean else np.zeros(n)
        scale = self.scale_ if self.with_std and self.scale_ is not None else np.ones(n)
        var = getattr(self, "var_", None)
        seen = np.broadcast_to(np.asarray(getattr(self, "n_samples_seen_", 0)), (n,))
        return [ColumnScaler("standard", float(center[i]), float(scale[i]),
                             None if var is None else float(var[i]), int(seen[i]))
                for i in range(n)]


class _RobustScaler:
    """scikit-learn's RobustScaler as its pickle holds it (quantile range
    25-75, no unit variance), one column."""

    @classmethod
    def of(cls, col: ColumnScaler) -> "_RobustScaler":
        out = cls()
        out.__dict__.update(
            with_centering=True, with_scaling=True, quantile_range=(25.0, 75.0),
            unit_variance=False, copy=True, n_features_in_=1,
            center_=np.asarray([col.center], np.float64),
            scale_=np.asarray([col.scale], np.float64))
        return out

    def columns(self) -> List[ColumnScaler]:
        n = int(getattr(self, "n_features_in_", 1))
        center = self.center_ if self.with_centering else np.zeros(n)
        scale = self.scale_ if self.with_scaling else np.ones(n)
        return [ColumnScaler("robust", float(center[i]), float(scale[i])) for i in range(n)]


_STAND_INS = {"standard": _StandardScaler, "robust": _RobustScaler}
_SKLEARN_NAMES = {_StandardScaler: (_SKLEARN_MODULE, "StandardScaler"),
                  _RobustScaler: (_SKLEARN_MODULE, "RobustScaler")}


class _ScalerUnpickler(RestrictedUnpickler):
    def __init__(self, f):
        super().__init__(f, ARTIFACT_NAME, {v: k for k, v in _SKLEARN_NAMES.items()})

    def refuse(self, module, name):
        raise NotImplementedError(
            f"{ARTIFACT_NAME} holds a {module}.{name}: the port reads scikit-learn's "
            "StandardScaler and RobustScaler; the other scaler modes are not ported yet "
            "(ROADMAP.md §1 item 2)")


def save_scaler(columns: List[ColumnScaler], path: str, as_list: bool = False) -> None:
    """Write ``columns`` as joblib writes scikit-learn scalers: one object,
    or a list of one-column scalers when ``as_list``."""
    objs = [_STAND_INS[c.method].of(c) for c in columns]
    with open(path, "wb") as f:
        GlobalPickler(f, _SKLEARN_NAMES).dump(objs if as_list else objs[0])


def load_scaler(path: str) -> List[ColumnScaler]:
    """The column scalers in ``path``: either package's pickle, or this
    package's earlier ``.npz`` archive."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":
            with np.load(path, allow_pickle=False) as z:
                return [ColumnScaler(str(m), float(c), float(s))
                        for m, c, s in zip(z["method"], z["center"], z["scale"])]
        f.seek(0)
        obj = _ScalerUnpickler(f).load()
    objs = obj if isinstance(obj, list) else [obj]
    if not objs or not all(isinstance(o, tuple(_SKLEARN_NAMES)) for o in objs):
        raise ValueError(f"{path} holds no scikit-learn scaler: {type(obj).__name__}")
    return [col for o in objs for col in o.columns()]
