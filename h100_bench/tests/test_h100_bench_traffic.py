"""The traffic generator repeats exactly for one seed, and every seed gets
the same sizes in another order."""

from __future__ import annotations

import numpy as np
import pytest

from small import CELLS, small_cell

from h100_bench import traffic

BIG_SEED = 2 ** 31 + 12345


def _generate(cell, seed):
    kind = cell.mix["dataset"]["kind"]
    return (traffic.molecules if kind == "molecules" else traffic.crystals)(
        cell.config, cell.mix, seed)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_traffic_repeats_for_one_seed(name):
    cell = small_cell(name)
    assert _same(_generate(cell, BIG_SEED), _generate(cell, BIG_SEED))
    assert not _same(_generate(cell, BIG_SEED), _generate(cell, BIG_SEED + 1))


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_traffic_sizes_do_not_depend_on_the_seed(name):
    cell = small_cell(name)
    a, b = _generate(cell, 1), _generate(cell, BIG_SEED)
    assert sorted(a["n_atoms"]) == sorted(b["n_atoms"])
    assert not np.array_equal(a["n_atoms"], b["n_atoms"])


def test_h100_bench_molecules_fit_their_pads():
    cell = small_cell(CELLS[0])
    d = _generate(cell, BIG_SEED)
    pad = cell.config["atom_pad_idx"]
    real = (d["src_tokens"] != pad).sum(axis=1)
    assert np.array_equal(real, d["n_atoms"])
    assert np.array_equal(d["attention_mask"].sum(axis=1), d["n_tokens"])
    # coordinates only on the atoms, one step apart along the walk
    r = 0
    n = d["n_atoms"][r]
    steps = np.linalg.norm(np.diff(d["src_coord"][r, 1:n - 1], axis=0), axis=1)
    assert np.allclose(steps, cell.mix["dataset"]["step_angstrom"], atol=1e-5)
    assert not d["src_coord"][r, n:].any() and not d["src_coord"][r, 0].any()


def test_h100_bench_epoch_orders_are_permutations():
    order = traffic.epoch_orders(64, 8, 3, BIG_SEED)
    assert order.shape == (24, 8)
    for e in range(3):
        assert sorted(order[e * 8:(e + 1) * 8].reshape(-1)) == list(range(64))
    assert np.array_equal(order, traffic.epoch_orders(64, 8, 3, BIG_SEED))
