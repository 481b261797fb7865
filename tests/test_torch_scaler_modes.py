"""Every target_normalize mode of the port (mmdti_tpu_torch/data/scaler.py,
numpy and scipy only) against the JAX package's TargetScaler (scikit-learn)
on the CPU:

* transform and inverse_transform of each mode at 1e-12 relative, for
  regression and for multilabel_regression with NaN holes in its columns;
  the fitted attributes scikit-learn keeps; Box-Cox and Yeo-Johnson λ;
* quantile below and above 10,000 rows, np.random seeded alike before each
  package's fit: the same quantiles and the same global RandomState after;
* target_scaler.ss both ways for every class: the JAX package's file read
  by the port, the port's read by joblib.load, with the same numbers; the
  ufuncs log1p and expm1 read under each module name numpy pickles them
  by.

The fits of both packages with these modes run beside the other fits,
in files whose process has already compiled the JAX package's fit:
tests/test_torch_fit.py (regression with power_trans; normalizer failing
both packages' fits at their first validation) and
tests/test_torch_fit_multilabel_regression.py (quantile over NaN-masked
columns).
"""

import warnings

import joblib
import numpy as np
import pytest

from mmdti_tpu.data.scaler import TargetScaler as JaxScaler
from mmdti_tpu_torch.data.scaler import ARTIFACT_NAME, TargetScaler

RTOL = 1e-12
MODES = ("minmax", "standard", "robust", "maxabs", "quantile", "power_trans", "normalizer",
         "log1p", "auto")
CLASSES = {"minmax": "MinMaxScaler", "standard": "StandardScaler", "robust": "RobustScaler",
           "maxabs": "MaxAbsScaler", "quantile": "QuantileTransformer",
           "power_trans": "PowerTransformer", "normalizer": "Normalizer",
           "log1p": "FunctionTransformer"}


def _targets(task, kind):
    """Seeded targets: 'mixed' sign (Yeo-Johnson), 'positive' (Box-Cox,
    log1p); multilabel columns with NaN holes."""
    rng = np.random.RandomState(0 if task == "regression" else 1)
    y = rng.randn(50, 1 if task == "regression" else 3) ** 3 * 2
    if kind == "positive":
        y = np.abs(y) + 0.05
    if task == "multilabel_regression":
        y[[3, 9, 20], [0, 2, 2]] = np.nan
    return y


def _probe(y):
    """Rows to map: the targets themselves and values between and past them."""
    rng = np.random.RandomState(7)
    extra = np.abs(rng.randn(8, y.shape[1])) * 2 + 0.01
    return np.concatenate([y, extra])


def _pair(mode, task, kind):
    y = _targets(task, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = JaxScaler(mode, task)
        theirs.fit(y)
    ours = TargetScaler(mode, task)
    ours.fit(y)
    return y, theirs, ours


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)


# log1p takes positive targets only: below -1 it is NaN in both packages
@pytest.mark.parametrize("mode,kind", [(m, k) for m in MODES for k in ("mixed", "positive")
                                       if (m, k) != ("log1p", "mixed")])
@pytest.mark.parametrize("task", ["regression", "multilabel_regression"])
def test_mode_matches_jax(mode, task, kind):
    y, theirs, ours = _pair(mode, task, kind)
    x = _probe(y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = theirs.transform(x)
        _close(ours.transform(x), t)
        if mode != "normalizer":
            _close(ours.inverse_transform(t), theirs.inverse_transform(t))
            # the round trip returns the targets
            np.testing.assert_allclose(ours.inverse_transform(ours.transform(y)), y,
                                       rtol=1e-9, atol=1e-9, equal_nan=True)
    # the fitted attributes scikit-learn keeps, column by column
    want = theirs.scaler if isinstance(theirs.scaler, list) else [theirs.scaler]
    assert len(ours.scaler) == len(want)
    for got, sk in zip(ours.scaler, want):
        assert type(got).__name__ == f"_{type(sk).__name__}"
        state = {k: v for k, v in vars(sk).items() if k != "_sklearn_version"}
        assert set(vars(got)) == set(state)
        for k, v in state.items():
            if isinstance(v, np.ndarray):
                _close(getattr(got, k), v)


def test_power_lambdas_match_scipy_through_scikit_learn():
    for kind, method in (("positive", "box-cox"), ("mixed", "yeo-johnson")):
        _, theirs, ours = _pair("power_trans", "multilabel_regression", kind)
        for got, sk in zip(ours.scaler, theirs.scaler):
            assert got.method == sk.method == method
            np.testing.assert_array_equal(got.lambdas_, sk.lambdas_)
            _close(got._scaler.mean_, sk._scaler.mean_)
            _close(got._scaler.scale_, sk._scaler.scale_)


@pytest.mark.parametrize("n", [2_000, 12_000])
def test_quantile_subsamples_as_scikit_learn(n):
    y = np.random.RandomState(2).standard_t(3, size=(n, 1))
    np.random.seed(11)
    theirs = JaxScaler("quantile", "regression")
    theirs.fit(y)
    after_jax = np.random.get_state()[1].copy()
    np.random.seed(11)
    ours = TargetScaler("quantile", "regression")
    ours.fit(y)
    np.testing.assert_array_equal(np.random.get_state()[1], after_jax)
    np.testing.assert_array_equal(ours.scaler[0].quantiles_, theirs.scaler.quantiles_)
    assert ours.scaler[0].n_quantiles_ == theirs.scaler.n_quantiles_ == 1000
    x = _probe(y[:40])
    _close(ours.transform(x), theirs.transform(x))
    _close(ours.inverse_transform(ours.transform(x)), theirs.inverse_transform(
        theirs.transform(x)))


@pytest.mark.parametrize("task", ["regression", "multilabel_regression"])
@pytest.mark.parametrize("mode", [m for m in MODES if m != "auto"])
def test_artifact_both_ways(mode, task, tmp_path):
    kind = "positive" if mode in ("log1p", "power_trans") else "mixed"
    y = _targets(task, kind)
    if mode == "normalizer":
        y = np.nan_to_num(y, nan=1.5)     # scikit-learn's Normalizer fits finite rows only
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = JaxScaler(mode, task)
        theirs.fit(y, str(jax_dir))
        ours = TargetScaler(mode, task)
        ours.fit(y, str(port_dir))
        # the JAX package's file, read by the port
        read = TargetScaler(mode, task, str(jax_dir))
        # the port's file, read by joblib: scikit-learn's own classes
        restored = joblib.load(str(port_dir / ARTIFACT_NAME))
        objs = restored if isinstance(restored, list) else [restored]
        assert isinstance(restored, list) == (task == "multilabel_regression")
        assert [type(o).__name__ for o in objs] == [CLASSES[mode]] * y.shape[1]
        by_joblib = JaxScaler(mode, task)
        by_joblib.scaler = restored
        x = _probe(np.nan_to_num(y, nan=1.0))
        t = theirs.transform(x)
        for got in (read, ours):
            _close(got.transform(x), t)
        _close(by_joblib.transform(x), t)
        if mode != "normalizer":
            want = theirs.inverse_transform(t)
            for got in (read, ours, by_joblib):
                _close(got.inverse_transform(t), want)
        # the port's file read back by the port: the same numbers
        again = TargetScaler(mode, task, str(port_dir))
        np.testing.assert_array_equal(again.transform(x), ours.transform(x))


def test_the_reader_takes_log1p_and_expm1_under_each_numpy_name():
    """A pickled ufunc names numpy._core._multiarray_umath (numpy 2.0),
    numpy.core._multiarray_umath (numpy 1) or numpy (later numpy 2); the
    reader takes log1p and expm1 under each and no other ufunc."""
    import io
    import pickle

    from mmdti_tpu_torch.data.scaler import _ScalerUnpickler

    reader = _ScalerUnpickler(io.BytesIO(b""))
    for module in ("numpy._core._multiarray_umath", "numpy.core._multiarray_umath", "numpy"):
        assert reader.find_class(module, "log1p") is np.log1p
        assert reader.find_class(module, "expm1") is np.expm1
        with pytest.raises(NotImplementedError, match="exp"):
            reader.find_class(module, "exp")
    assert pickle.loads(pickle.dumps(np.log1p)) is np.log1p
