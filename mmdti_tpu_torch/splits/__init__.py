"""Dataset splits (port of mmdti_tpu/splits/__init__.py).

``Splitter('Nfold_{random,scaffold,group,stratified}', seed)``: the fold
index pairs of scikit-learn's KFold(shuffle=True, random_state=seed),
GroupKFold and StratifiedKFold(shuffle=True, random_state=seed), written
in numpy with scikit-learn's draws and tie-breaks, so both packages give
the same folds; a split that cannot be made raises scikit-learn's message
inside the JAX package's ValueError.
``random_scaffold_split``: scaffold buckets in an RNG-permuted order, filled
greedily test -> valid -> train (reference tasks/split.py:86-132).
``random_split``: scikit-learn's ``train_test_split`` twice, written out
(a RandomState permutation; the test rows come first).  Both take a CSV
path or a table (data/reader.py) and return three tables.
"""

from __future__ import annotations

import math
import warnings
from collections import defaultdict

import numpy as np

from mmdti_tpu_torch.chem.scaffold import murcko_scaffold
from mmdti_tpu_torch.data.reader import as_table, num_rows, take_rows


class Splitter:
    def __init__(self, split_method: str = "5fold_random", seed: int = 42):
        self.n_splits = int(split_method.split("fold")[0])
        self.method = split_method.split("_")[-1]
        self.seed = seed
        if self.method not in ("random", "scaffold", "group", "stratified"):
            raise ValueError(f"Unknown splitter method: {self.n_splits}fold - {self.method}")
        if self.n_splits < 2:
            raise ValueError(
                "k-fold cross-validation requires at least one train/test split by setting "
                f"n_splits=2 or more, got n_splits={self.n_splits}.")

    def split(self, data, target=None, group=None):
        """[(train indices, test indices)] per fold, positions into ``data``."""
        try:
            n = len(data)
            if self.n_splits > n:
                raise ValueError(
                    f"Cannot have number of splits n_splits={self.n_splits} greater than the "
                    f"number of samples: n_samples={n}.")
            if self.method == "random":
                folds = _kfold_folds(n, self.n_splits, self.seed)
            elif self.method in ("scaffold", "group"):
                folds = _group_kfold_folds(group, self.n_splits)
            else:
                folds = _stratified_folds(target, self.n_splits, self.seed)
            indices = np.arange(n)
            return [(indices[folds != f], indices[folds == f]) for f in range(self.n_splits)]
        except Exception as e:
            raise ValueError(f"{self.n_splits}fold_{self.method} split failed: {e}") from e


def _kfold_folds(n: int, n_splits: int, seed: int) -> np.ndarray:
    """KFold(shuffle=True): the shuffled indices cut into n_splits runs,
    the first n % n_splits one longer; returns each sample's fold."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    folds = np.empty(n, dtype=int)
    folds[order] = np.repeat(np.arange(n_splits), sizes)
    return folds


def _group_kfold_folds(groups, n_splits: int) -> np.ndarray:
    """GroupKFold: groups by size, largest first (ties: the later group in
    sorted order first), each into the fold holding the fewest samples
    (ties: the lowest fold)."""
    if groups is None:
        raise ValueError("The 'groups' parameter should not be None.")
    unique, group_idx = np.unique(np.asarray(groups), return_inverse=True)
    if n_splits > len(unique):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of groups: {len(unique)}.")
    per_group = np.bincount(group_idx.reshape(-1))
    order = np.argsort(per_group, kind="stable")[::-1]
    per_fold = np.zeros(n_splits)
    group_fold = np.zeros(len(unique), dtype=int)
    for g in order:
        lightest = int(np.argmin(per_fold))
        per_fold[lightest] += per_group[g]
        group_fold[g] = lightest
    return group_fold[group_idx.reshape(-1)]


def _stratified_folds(y, n_splits: int, seed: int) -> np.ndarray:
    """StratifiedKFold(shuffle=True): classes encoded in order of first
    appearance, each class's per-fold counts from a round robin over the
    sorted labels, its fold labels shuffled class by class."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.reshape(-1)
    if y.ndim != 1:
        raise ValueError(f"Supported target types are: ('binary', 'multiclass'). Got "
                         f"a {y.ndim}-d target of shape {y.shape} instead.")
    if y.dtype.kind == "f" and not np.array_equal(y, np.round(y)):
        raise ValueError("Supported target types are: ('binary', 'multiclass'). Got "
                         "'continuous' instead.")
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    encoded = class_perm[inverse.reshape(-1)]
    n_classes = len(first)
    counts = np.bincount(encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only {counts.min()} members, which "
                      f"is less than n_splits={n_splits}.", UserWarning)
    ordered = np.sort(encoded)
    allocation = np.asarray([np.bincount(ordered[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(y), dtype=int)
    for k in range(n_classes):
        fold_of = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(fold_of)
        folds[encoded == k] = fold_of
    return folds


def random_scaffold_split(dataset, random_seed: int = 8, ratio_test: float = 0.1,
                          ration_valid: float = 0.1):
    rng = np.random.RandomState(random_seed)
    table = as_table(dataset)
    smiles_list = table["smiles"] if "smiles" in table else table["SMILES"]

    scaffolds = defaultdict(list)
    for ind, smiles in enumerate(smiles_list):
        scaffolds[murcko_scaffold(str(smiles), include_chirality=True)].append(ind)
    keys = rng.permutation(list(scaffolds.keys()))
    scaffold_sets = [scaffolds[k] for k in keys]

    n = num_rows(table)
    n_total_valid = int(ration_valid * n * (1 - ratio_test))
    n_total_test = int(ratio_test * n)
    train_idx, valid_idx, test_idx = [], [], []
    for ss in scaffold_sets:
        if len(test_idx) + len(ss) <= n_total_test:
            test_idx.extend(ss)
        elif len(valid_idx) + len(ss) <= n_total_valid:
            valid_idx.extend(ss)
        else:
            train_idx.extend(ss)
    assert len(set(train_idx)) + len(set(test_idx)) + len(set(valid_idx)) == n
    return take_rows(table, train_idx), take_rows(table, valid_idx), take_rows(table, test_idx)


def _train_test_split(n: int, test_size: float, random_state: int):
    """scikit-learn's ShuffleSplit indices for a float test_size."""
    n_test = int(math.ceil(test_size * n))
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:], perm[:n_test]


def random_split(data, random_seed: int = 8, ratio_test: float = 0.1,
                 ration_valid: float = 0.1):
    table = as_table(data)
    rest, test = _train_test_split(num_rows(table), ratio_test, random_seed)
    tr, va = _train_test_split(len(rest), ration_valid, random_seed)
    return (take_rows(table, rest[tr]), take_rows(table, rest[va]), take_rows(table, test))
