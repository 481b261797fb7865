"""Target scaling (port of mmdti_tpu/data/scaler.py) in numpy.

Regression and multilabel regression with every mode of the JAX package,
each the scikit-learn transformer it names, rewritten in numpy (scipy where
scikit-learn itself calls scipy): ``minmax`` (MinMaxScaler, range (0, 1)),
``standard`` (StandardScaler: mean and the ddof-0 std), ``robust``
(RobustScaler: median and the 25-75 interquantile range), ``maxabs``
(MaxAbsScaler), ``quantile`` (QuantileTransformer, uniform output, at most
1,000 quantiles from at most 10,000 rows drawn from numpy's global
RandomState), ``power_trans`` (PowerTransformer: Box-Cox when every target
is positive, else Yeo-Johnson, then standardized), ``normalizer``
(Normalizer: each one-column row to unit norm, with no inverse, so a fit
that needs one raises as scikit-learn's does), ``log1p`` (FunctionTransformer
of log1p with expm1 as its inverse) and ``auto`` (robust when |skew| > 5 or
|kurtosis| > 20, else standard).  Near-zero scales become 1, as in
scikit-learn.  Multilabel regression fits one transform a column on its
non-NaN rows.

Each mode is one column transform class under scikit-learn's class name
whose instance dict is exactly what scikit-learn pickles of the fitted
object; ``fitted(values)`` builds it from a [n, 1] column, and
``transform`` / ``inverse_transform`` take [n, 1] arrays.  They persist as
``target_scaler.ss`` in the experiment dir, in the JAX package's format: the
pickle ``joblib.dump`` writes of the fitted scikit-learn object (a list, one
a column, for multilabel_regression), written and read here without either
package (utils/joblib_pickle.py); a file naming another class raises.  The
``.npz`` archive earlier versions of this package wrote is still read (a
zip: its first bytes are ``PK``).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
from scipy import special, stats
from scipy.stats import kurtosis, skew

from mmdti_tpu_torch.parallel.mesh import is_writer_process
from mmdti_tpu_torch.utils.joblib_pickle import GlobalPickler, RestrictedUnpickler

logger = logging.getLogger("mmdti_tpu_torch")

_CLS_TASKS = ("classification", "multiclass", "multilabel_classification")
ARTIFACT_NAME = "target_scaler.ss"
_EPS = np.finfo(np.float64).eps
# QuantileTransformer's defaults
N_QUANTILES = 1000
SUBSAMPLE = 10_000


def _handle_zeros_in_scale(scale, constant_mask=None):
    """scikit-learn's rule: a scale under 10 eps (or a constant feature's)
    becomes 1."""
    scale = np.array(scale, dtype=np.float64)
    scale[scale < 10 * _EPS if constant_mask is None else constant_mask] = 1.0
    return scale


def _is_constant_feature(var, mean, n_samples):
    """scikit-learn's bound on the two-pass variance of a constant column."""
    return var <= n_samples * _EPS * var + (n_samples * mean * _EPS) ** 2


def _column(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float64).reshape(-1, 1)


class _Transform:
    """A fitted column transform; its instance dict is scikit-learn's."""

    def __init__(self, **state):
        self.__dict__.update(state)


class _Affine(_Transform):
    """x -> (x - center) / scale, the centre and scale from ``_affine()``."""

    def transform(self, x):
        center, scale = self._affine()
        return (np.asarray(x, dtype=np.float64) - center) / scale

    def inverse_transform(self, x):
        center, scale = self._affine()
        return np.asarray(x, dtype=np.float64) * scale + center


class _StandardScaler(_Affine):
    @classmethod
    def fitted(cls, values) -> "_StandardScaler":
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        mean, std = v.mean(), v.std()
        return cls(with_mean=True, with_std=True, copy=True, n_features_in_=1,
                   n_samples_seen_=np.int64(v.size), mean_=np.asarray([mean]),
                   var_=np.asarray([v.var()]), scale_=_handle_zeros_in_scale([std]))

    @classmethod
    def nested(cls, x) -> "_StandardScaler":
        """The StandardScaler(copy=False) a PowerTransformer fits, by
        scikit-learn's corrected two-pass mean and variance."""
        n = x.shape[0]
        mean = np.sum(x, axis=0) / n
        temp = x - mean
        correction = np.sum(temp, axis=0)
        var = (np.sum(temp ** 2, axis=0) - correction ** 2 / n) / n
        scale = _handle_zeros_in_scale(np.sqrt(var), _is_constant_feature(var, mean, n))
        return cls(with_mean=True, with_std=True, copy=False,
                   _sklearn_output_config={"transform": "default"}, n_features_in_=x.shape[1],
                   n_samples_seen_=np.float64(n), mean_=mean, var_=var, scale_=scale)

    def _affine(self):
        center = self.mean_ if self.with_mean else 0.0
        scale = self.scale_ if self.with_std and self.scale_ is not None else 1.0
        return center, scale


class _RobustScaler(_Affine):
    @classmethod
    def fitted(cls, values) -> "_RobustScaler":
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        q25, q75 = np.nanpercentile(v, (25.0, 75.0))
        return cls(with_centering=True, with_scaling=True, quantile_range=(25.0, 75.0),
                   unit_variance=False, copy=True, n_features_in_=1,
                   center_=np.asarray([np.nanmedian(v)]),
                   scale_=_handle_zeros_in_scale([q75 - q25]))

    def _affine(self):
        return (self.center_ if self.with_centering else 0.0,
                self.scale_ if self.with_scaling else 1.0)


class _MinMaxScaler(_Transform):
    @classmethod
    def fitted(cls, values) -> "_MinMaxScaler":
        x = _column(values)
        data_min, data_max = np.nanmin(x, axis=0), np.nanmax(x, axis=0)
        data_range = data_max - data_min
        scale = 1.0 / _handle_zeros_in_scale(data_range)
        return cls(feature_range=(0, 1), copy=True, clip=False, n_features_in_=1,
                   n_samples_seen_=x.shape[0], scale_=scale, min_=0.0 - data_min * scale,
                   data_min_=data_min, data_max_=data_max, data_range_=data_range)

    def transform(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.min_

    def inverse_transform(self, x):
        return (np.asarray(x, dtype=np.float64) - self.min_) / self.scale_


class _MaxAbsScaler(_Transform):
    @classmethod
    def fitted(cls, values) -> "_MaxAbsScaler":
        x = _column(values)
        max_abs = np.nanmax(np.abs(x), axis=0)
        return cls(copy=True, clip=False, n_features_in_=1, n_samples_seen_=x.shape[0],
                   max_abs_=max_abs, scale_=_handle_zeros_in_scale(max_abs))

    def transform(self, x):
        return np.asarray(x, dtype=np.float64) / self.scale_

    def inverse_transform(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale_


class _QuantileTransformer(_Transform):
    """Uniform output.  Past SUBSAMPLE rows the quantiles come from
    SUBSAMPLE rows drawn as scikit-learn's ``resample`` draws them with
    ``random_state=None``: a shuffle of the row indices by numpy's global
    RandomState."""

    @classmethod
    def fitted(cls, values) -> "_QuantileTransformer":
        x = _column(values)
        n = x.shape[0]
        n_quantiles = max(1, min(N_QUANTILES, n))
        references = np.linspace(0, 1, n_quantiles, endpoint=True)
        if SUBSAMPLE < n:
            rows = np.arange(n)
            np.random.mtrand._rand.shuffle(rows)
            x = x[rows[:SUBSAMPLE]]
        return cls(n_quantiles=N_QUANTILES, output_distribution="uniform",
                   ignore_implicit_zeros=False, subsample=SUBSAMPLE, random_state=None,
                   copy=True, n_features_in_=1, n_quantiles_=n_quantiles,
                   references_=references,
                   quantiles_=np.nanpercentile(x, references * 100, axis=0))

    def _column_map(self, col, quantiles, inverse):
        col = col.copy()
        if inverse:
            bounds_x, bounds_y = (0, 1), (quantiles[0], quantiles[-1])
        else:
            bounds_x, bounds_y = (quantiles[0], quantiles[-1]), (0, 1)
        with np.errstate(invalid="ignore"):
            lower, upper = col == bounds_x[0], col == bounds_x[1]
        finite = ~np.isnan(col)
        v = col[finite]
        if inverse:
            col[finite] = np.interp(v, self.references_, quantiles)
        else:
            # the mean of the interpolations up and down (repeated quantiles)
            col[finite] = 0.5 * (np.interp(v, quantiles, self.references_)
                                 - np.interp(-v, -quantiles[::-1], -self.references_[::-1]))
        col[upper] = bounds_y[1]
        col[lower] = bounds_y[0]
        return col

    def _map(self, x, inverse):
        x = np.array(x, dtype=np.float64)
        for i in range(x.shape[1]):
            x[:, i] = self._column_map(x[:, i], self.quantiles_[:, i], inverse)
        return x

    def transform(self, x):
        return self._map(x, inverse=False)

    def inverse_transform(self, x):
        return self._map(x, inverse=True)


def _yeo_johnson_inverse(x, lmbda):
    """PowerTransformer._yeo_johnson_inverse_transform."""
    out = np.zeros_like(x)
    pos = x >= 0
    if abs(lmbda) < np.spacing(1.0):
        out[pos] = np.exp(x[pos]) - 1
    else:
        out[pos] = np.power(x[pos] * lmbda + 1, 1 / lmbda) - 1
    if abs(lmbda - 2) > np.spacing(1.0):
        out[~pos] = 1 - np.power(-(2 - lmbda) * x[~pos] + 1, 1 / (2 - lmbda))
    else:
        out[~pos] = 1 - np.exp(-x[~pos])
    return out


class _PowerTransformer(_Transform):
    """λ a column by maximum likelihood through scipy (``stats.boxcox`` /
    ``stats.yeojohnson`` with ``lmbda=None``, as scikit-learn calls them),
    then standardized by a nested StandardScaler."""

    _FORWARD = {"box-cox": special.boxcox, "yeo-johnson": stats.yeojohnson}
    _INVERSE = {"box-cox": special.inv_boxcox, "yeo-johnson": _yeo_johnson_inverse}

    @classmethod
    def fitted(cls, values) -> "_PowerTransformer":
        x = np.array(values, dtype=np.float64).reshape(-1, 1)     # transformed in place below
        method = "box-cox" if np.min(x) > 0 else "yeo-johnson"
        n = x.shape[0]
        mean, var = np.mean(x, axis=0, dtype=np.float64), np.var(x, axis=0, dtype=np.float64)
        lambdas = np.empty(x.shape[1], dtype=np.float64)
        with np.errstate(invalid="ignore"):
            for i in range(x.shape[1]):
                col = x[:, i]
                if method == "yeo-johnson" and _is_constant_feature(var[i], mean[i], n):
                    lambdas[i] = 1.0
                    continue
                valid = col[~np.isnan(col)]
                if method == "box-cox":
                    lambdas[i] = stats.boxcox(valid, lmbda=None)[1]
                else:
                    lambdas[i] = stats.yeojohnson(valid, lmbda=None)[1]
                x[:, i] = cls._FORWARD[method](col, lambdas[i])
        return cls(method=method, standardize=True, copy=True, n_features_in_=1,
                   lambdas_=lambdas, _scaler=_StandardScaler.nested(x))

    def transform(self, x):
        x = np.array(x, dtype=np.float64)
        if self.method == "box-cox" and np.nanmin(x) <= 0:
            raise ValueError("The Box-Cox transformation can only be applied to strictly "
                             "positive data")
        for i, lmbda in enumerate(self.lambdas_):
            with np.errstate(invalid="ignore"):
                x[:, i] = self._FORWARD[self.method](x[:, i], lmbda)
        return self._scaler.transform(x) if self.standardize else x

    def inverse_transform(self, x):
        x = np.array(x, dtype=np.float64)
        if self.standardize:
            x = self._scaler.inverse_transform(x)
        for i, lmbda in enumerate(self.lambdas_):
            x[:, i] = self._INVERSE[self.method](x[:, i], lmbda)
        return x


class _Normalizer(_Transform):
    """l2 over a row: one column maps each value to its sign (a value under
    10 eps in magnitude stays as it is).  scikit-learn's Normalizer has no
    inverse_transform."""

    @classmethod
    def fitted(cls, values) -> "_Normalizer":
        x = _column(values)
        if not np.all(np.isfinite(x)):
            raise ValueError("Input X contains NaN or infinity: the Normalizer fits finite "
                             "targets only")
        return cls(norm="l2", copy=True, n_features_in_=x.shape[1])

    def transform(self, x):
        x = np.asarray(x, dtype=np.float64)
        norms = _handle_zeros_in_scale(np.sqrt(np.einsum("ij,ij->i", x, x)))
        return x / norms[:, None]

    def inverse_transform(self, x):
        raise ValueError(
            "target_normalize='normalizer' has no inverse_transform: scikit-learn's Normalizer "
            "defines none, so predictions cannot return to the target's scale (the JAX "
            "package's fit fails at the same point)")


class _FunctionTransformer(_Transform):
    """FunctionTransformer(np.log1p, inverse_func=np.expm1): ``func`` and
    ``inverse_func`` are those two ufuncs (the only ones the reader takes)."""

    @classmethod
    def fitted(cls, values) -> "_FunctionTransformer":
        return cls(func=np.log1p, inverse_func=np.expm1, validate=False, accept_sparse=False,
                   check_inverse=True, feature_names_out=None, kw_args=None, inv_kw_args=None,
                   n_features_in_=_column(values).shape[1])

    def transform(self, x):
        return self.func(np.asarray(x, dtype=np.float64))

    def inverse_transform(self, x):
        return self.inverse_func(np.asarray(x, dtype=np.float64))


_DATA = "sklearn.preprocessing._data"
SCALER_MODE = {
    "minmax": _MinMaxScaler,
    "standard": _StandardScaler,
    "robust": _RobustScaler,
    "maxabs": _MaxAbsScaler,
    "quantile": _QuantileTransformer,
    "power_trans": _PowerTransformer,
    "normalizer": _Normalizer,
    "log1p": _FunctionTransformer,
}
_SKLEARN_NAMES = {cls: (_DATA, cls.__name__[1:]) for cls in SCALER_MODE.values()}
_SKLEARN_NAMES[_FunctionTransformer] = ("sklearn.preprocessing._function_transformer",
                                        "FunctionTransformer")


class TargetScaler:
    def __init__(self, ss_method: str, task: str, load_dir: Optional[str] = None):
        self.ss_method = ss_method
        self.task = task
        self.scaler: Optional[List[_Transform]] = None      # one transform a column
        if load_dir and os.path.exists(os.path.join(load_dir, ARTIFACT_NAME)):
            self.scaler = load_scaler(os.path.join(load_dir, ARTIFACT_NAME))

    def is_skewed(self, target) -> bool:
        if self.task in _CLS_TASKS:
            return False
        t = np.asarray(target, dtype=np.float64).reshape(-1)
        t = t[~np.isnan(t)]
        return abs(skew(t)) > 5.0 or abs(kurtosis(t)) > 20.0

    def _make(self, values) -> _Transform:
        method = self.ss_method
        if method == "auto":
            method = "robust" if self.is_skewed(values) else "standard"
            logger.info("Auto selected %s transformer.", method)
        if method not in SCALER_MODE:
            raise ValueError(f"Unknown scaler method: {method!r}; expected one of "
                             f"{sorted(SCALER_MODE)}, 'auto' or 'none'")
        return SCALER_MODE[method].fitted(values)

    def fit(self, target, dump_dir: Optional[str] = None) -> None:
        if self.task in _CLS_TASKS or self.ss_method == "none":
            return
        target = np.asarray(target, dtype=np.float64)
        if target.ndim == 1:
            target = target.reshape(-1, 1)
        if self.task == "regression":
            self.scaler = [self._make(target)]
        elif self.task == "multilabel_regression":
            self.scaler = []
            for i in range(target.shape[1]):
                col = target[:, i]
                self.scaler.append(self._make(col[~np.isnan(col)]))
        if dump_dir and is_writer_process():      # rank 0 writes (parallel/mesh.py)
            os.makedirs(dump_dir, exist_ok=True)
            save_scaler(self.scaler, os.path.join(dump_dir, ARTIFACT_NAME),
                        as_list=self.task == "multilabel_regression")

    def transform(self, target):
        if self.task in _CLS_TASKS or self.ss_method == "none" or self.scaler is None:
            return target
        target = np.asarray(target, dtype=np.float64)
        if self.task == "regression":
            return self.scaler[0].transform(target.reshape(-1, 1)).reshape(target.shape)
        if self.task == "multilabel_regression":
            out = np.array(target, dtype=np.float64)
            for i, sc in enumerate(self.scaler):
                mask = ~np.isnan(target[:, i])
                if mask.any():
                    out[mask, i] = sc.transform(target[mask, i:i + 1])[:, 0]
            return out
        return target

    def inverse_transform(self, target):
        if self.task in _CLS_TASKS or self.ss_method == "none" or self.scaler is None:
            return target
        target = np.asarray(target, dtype=np.float64)
        if self.task == "regression":
            return self.scaler[0].inverse_transform(target.reshape(-1, 1)).reshape(target.shape)
        if self.task == "multilabel_regression":
            out = np.zeros_like(target)
            for i, sc in enumerate(self.scaler):
                out[:, i] = sc.inverse_transform(target[:, i:i + 1])[:, 0]
            return out
        raise ValueError(f"Unknown scaler method: {self.ss_method}")


class _ScalerUnpickler(RestrictedUnpickler):
    def __init__(self, f):
        super().__init__(f, ARTIFACT_NAME, {v: k for k, v in _SKLEARN_NAMES.items()},
                         ufuncs=("log1p", "expm1"))

    def refuse(self, module, name):
        raise NotImplementedError(
            f"{ARTIFACT_NAME} holds a {module}.{name}: the port reads the scikit-learn "
            f"transformers of target_normalize's modes, "
            f"{sorted(n for _, n in _SKLEARN_NAMES.values())}, and nothing else")


def save_scaler(columns: List[_Transform], path: str, as_list: bool = False) -> None:
    """Write the column transforms as joblib writes scikit-learn's: one
    object, or a list of one-column objects when ``as_list``."""
    with open(path, "wb") as f:
        GlobalPickler(f, _SKLEARN_NAMES).dump(columns if as_list else columns[0])


def load_scaler(path: str) -> List[_Transform]:
    """The column transforms in ``path``: either package's pickle, or this
    package's earlier ``.npz`` archive (standard and robust only)."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":
            with np.load(path, allow_pickle=False) as z:
                return [_npz_column(str(m), float(c), float(s))
                        for m, c, s in zip(z["method"], z["center"], z["scale"])]
        f.seek(0)
        obj = _ScalerUnpickler(f).load()
    objs = obj if isinstance(obj, list) else [obj]
    if not objs or not all(isinstance(o, _Transform) for o in objs):
        raise ValueError(f"{path} holds no scikit-learn scaler: {type(obj).__name__}")
    return objs


def _npz_column(method: str, center: float, scale: float) -> _Transform:
    if method == "robust":
        return _RobustScaler(with_centering=True, with_scaling=True, n_features_in_=1,
                             center_=np.asarray([center]), scale_=np.asarray([scale]))
    return _StandardScaler(with_mean=True, with_std=True, n_features_in_=1,
                           mean_=np.asarray([center]), scale_=np.asarray([scale]))
