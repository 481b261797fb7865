"""``correct`` fails where it has to: the control (the reference in fp8 in
the program's place) and the faults a train cell can have, each planted
under a run driven without the harness's look for a card; and, on the
card, one short run of each cell gives the contract's line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from small import CELLS, ROOT, small_cell

from h100_bench import control
from h100_bench import run as harness
from h100_bench.registry import Registry


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_control_fails_the_limits(name):
    cell = small_cell(name)
    lines = {d["reader"]: d for d in control.readings(cell, 2 ** 31 + 7, "cpu")}
    for reader in ("control", "half_batch"):
        assert any(lines[reader][k] > cell.limits[k] for k in cell.limits), (reader, lines[reader])


def _unchanged(monkeypatch):
    """Each step computes its loss and leaves the parameters and the
    optimizer's state as they were."""
    from mmdti_tpu_torch.train.steps import TrainPrograms

    feed = TrainPrograms.feed

    def still(self, resident, idx_k):
        saved = [t.clone() for t in self.optimizer.graph_state]
        out = feed(self, resident, idx_k)
        with torch.no_grad():
            for t, s in zip(self.optimizer.graph_state, saved):
                t.copy_(s)
        return out

    monkeypatch.setattr(TrainPrograms, "feed", still)


def _params_unchanged(monkeypatch):
    """Each step moves Adam's moments and counts and leaves the parameters
    as they were."""
    from mmdti_tpu_torch.train.steps import TrainPrograms

    feed = TrainPrograms.feed

    def still(self, resident, idx_k):
        flat = self.optimizer.named_state["params"]
        saved = flat.clone()
        out = feed(self, resident, idx_k)
        with torch.no_grad():
            flat.copy_(saved)
        return out

    monkeypatch.setattr(TrainPrograms, "feed", still)


def _optimizer_fault(monkeypatch, spoil):
    """``spoil(optimizer)`` once the optimizer is built, before any step."""
    from mmdti_tpu_torch.train.optim import FusedAdam

    init = FusedAdam.__init__

    def wrong(self, *a, **kw):
        init(self, *a, **kw)
        spoil(self)

    monkeypatch.setattr(FusedAdam, "__init__", wrong)


def _lr_doubled(monkeypatch):
    """Every step's learning rate twice the schedule's."""
    _optimizer_fault(monkeypatch, lambda opt: opt._lr.mul_(2.0))


def _no_bias_correction(monkeypatch):
    """Adam's moments taken without their bias corrections."""
    _optimizer_fault(monkeypatch, lambda opt: (opt._bc1.fill_(1.0), opt._bc2.fill_(1.0)))


def _half_batch(monkeypatch):
    """Each step takes the first half of its rows and the mean over them."""
    from mmdti_tpu_torch.train.steps import Resident

    take = Resident.take

    def half(self, idx, data_group=None):
        return take(self, idx[: idx.shape[0] // 2], data_group)

    monkeypatch.setattr(Resident, "take", half)


def _line(name):
    """A run of the small float32 cell on the CPU, as the harness reports
    it."""
    cell = small_cell(name, compute_dtype="float32")
    reg = Registry()
    drv = reg.driver(cell.mix["driver"])
    out = drv.run(cell, 2 ** 31 + 3, 0.2, False, start=harness.now(), clock=harness.now,
                  device="cpu")
    line = harness.result_line(cell, reg, out, False, {})
    assert list(line)[-1] == "checks"
    return line


def test_h100_bench_window_opens_at_process_age():
    """The window waits for ``opens_at``, the steps until then counted in
    set-up."""
    cell = small_cell(CELLS[0], compute_dtype="float32")
    start = harness.now()
    out = Registry().driver("train").run(cell, 2 ** 31 + 3, 0.2, False, start=start,
                                         clock=harness.now, device="cpu", opens_at=start + 3.0)
    assert out["e2e"]["setup_s"] >= 3.0 and out["phases"]["settle_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_sound_run_is_correct(name):
    line = _line(name)
    assert line["correct"] is True, line["checks"]


# each fault, and the number that has to catch it
FAULTS = [(_unchanged, "change_gap_median"), (_half_batch, "loss_gap"),
          (_params_unchanged, "change_gap_median"), (_lr_doubled, "change_gap_median"),
          (_no_bias_correction, "change_gap_median")]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,catcher", FAULTS, ids=[f.__name__.strip("_") for f, _ in FAULTS])
def test_h100_bench_faults_are_not_correct(monkeypatch, name, fault, catcher):
    fault(monkeypatch)
    line = _line(name)
    assert line["correct"] is False, line["checks"]
    c = line["checks"][catcher]
    assert c["value"] > c["limit"], line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_h100_bench_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", name, "--seed",
                          str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in Registry().end_to_end(name)}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
