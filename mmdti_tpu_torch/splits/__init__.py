"""Dataset splits (port of mmdti_tpu/splits/__init__.py without the
scikit-learn k-fold ``Splitter``).

``random_scaffold_split``: scaffold buckets in an RNG-permuted order, filled
greedily test -> valid -> train (reference tasks/split.py:86-132).
``random_split``: scikit-learn's ``train_test_split`` twice, written out
(a RandomState permutation; the test rows come first).  Both take a CSV
path or a table (data/reader.py) and return three tables.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from mmdti_tpu_torch.chem.scaffold import murcko_scaffold
from mmdti_tpu_torch.data.reader import as_table, num_rows, take_rows


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
