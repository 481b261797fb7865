"""The port's protocol script (mmdti_tpu_torch/finetune.py) against the
repo's finetune.py on the classification tasks, without pandas or
scikit-learn on the port's side:

* the synthetic CSV of each task equals the JAX script's byte for byte
  (the median split, pandas.qcut terciles, and the 10 % of t2 that
  DataFrame.sample blanks), over several seeds and sizes;
* _score_task equals the JAX script's (ROC-AUC, the macro one-vs-rest AUC
  with its missing-class NaN, the NaN-masked column mean) at 1e-12.
"""

import numpy as np
import pytest

from finetune import _score_task as jax_score_task
from finetune import make_synthetic_dataset as jax_make
from mmdti_tpu_torch.finetune import _score_task, make_synthetic_dataset

TASKS = ("classification", "multiclass", "multilabel_classification")


@pytest.mark.parametrize("seed,n", [(0, 400), (3, 120), (7, 57)])
@pytest.mark.parametrize("task", TASKS)
def test_synthetic_task_csv_equals_jax(tmp_path, task, seed, n):
    ours, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    make_synthetic_dataset(ours, n=n, seed=seed, task=task)
    jax_make(theirs, n=n, seed=seed, task=task)
    with open(ours) as a, open(theirs) as b:
        text = a.read()
        assert text == b.read()
    if task == "multilabel_classification":
        assert text.count(",\n") == round(0.1 * n)     # the blank t2 cells


def _score_inputs(task, seed):
    rng = np.random.RandomState(seed)
    if task == "classification":
        truth = rng.randint(0, 2, 34).astype(np.float64)
        if seed == 2:
            truth[:] = 1.0
        return truth, np.round(rng.rand(34, 1), 2).astype(np.float32)
    if task == "multiclass":
        truth = rng.randint(0, 3 if seed != 2 else 2, (34, 1)).astype(np.float64)
        p = rng.rand(34, 3).astype(np.float32)
        return truth, p / p.sum(axis=1, keepdims=True)
    truth = rng.randint(0, 2, (34, 3)).astype(np.float64)
    truth[::4, 2] = np.nan
    if seed == 2:
        truth[~np.isnan(truth[:, 1]), 1] = 0.0
    return truth, rng.rand(34, 3).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("task", TASKS)
def test_score_task_equals_jax(task, seed):
    truth, pred = _score_inputs(task, seed)
    got, want = _score_task(task, truth, pred, seed), jax_score_task(task, truth, pred, seed)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= 1e-12
