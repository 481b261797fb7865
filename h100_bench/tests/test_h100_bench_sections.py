"""The readers of the program's section marks and host span
(h100_bench/sections.py and the metrics that read it) on synthetic
traces, and, on the card, the marks of a replayed feed step."""

from __future__ import annotations

import pytest
import torch

import small  # noqa: F401  (puts the repo on the path)

from h100_bench import sections, trace
from h100_bench.registry import Cell, Registry
from h100_bench.trace import Trace
from mmdti_tpu_torch.train.profiler import MARKS

REG = Registry()
READ = {name: REG.metric(name).read for name in
        ("unimol_ms", "smiles_ms", "head_ms", "optimizer_ms", "kernels_per_step", "host_step_ms")}
# device us of the work after each mark in the synthetic step, as
# (operation, us) pairs; the end section holds the output's clone and the
# next step's input copy
WORK = {"step": [("gather", 1.0)], "unimol": [("gbf_mma_fwd", 4.0), ("gemm", 10.0)],
        "smiles": [("gemm", 5.0)], "head": [("elementwise", 2.0), ("reduce", 1.0)],
        "head_bwd": [("fill", 0.5)], "smiles_bwd": [("gemm", 6.0)],
        "unimol_bwd": [("pair_mma_bwd", 8.0), ("gemm", 12.0)], "optimizer": [("adam", 3.0)],
        "end": [("clone", 0.25), ("copy", 0.25)]}


def _events(steps=3, marks=MARKS, feed_us=(40.0, 30.0, 50.0)):
    """``steps`` steps between spin kernels, each one ``train.feed`` span
    on the host and the marks ``marks`` with WORK after each; mark kernels
    take 1 us."""
    ev, t = [], 0.0

    def op(name, dur, cat="kernel"):
        nonlocal t
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t, "dur": dur})
        t += dur

    op("spin_kernel", 5.0)
    for s in range(steps):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "train.feed", "ts": t,
                   "dur": feed_us[s % len(feed_us)]})
        for m in marks:
            op(f"trace_mark_{m}", 1.0)
            for name, dur in WORK[m]:
                op(name, dur, "gpu_memcpy" if name == "copy" else "kernel")
    op("spin_kernel", 5.0)
    return ev


class _Run:
    def __init__(self, events, steps=3):
        self.trace = Trace(events)
        self.steps = steps


def _us(*marks):
    return sum(d for m in marks for _, d in WORK[m])


@pytest.mark.parametrize("model", ["mmdti", "unimof"])
def test_h100_bench_sections_split_a_step(model):
    marks = MARKS if model == "mmdti" else tuple(m for m in MARKS if "smiles" not in m)
    run = _Run(_events(marks=marks))
    assert READ["unimol_ms"](run) == pytest.approx(_us("unimol", "unimol_bwd") / 1e3)
    assert READ["head_ms"](run) == pytest.approx(_us("head", "head_bwd") / 1e3)
    assert READ["optimizer_ms"](run) == pytest.approx(_us("optimizer") / 1e3)
    if model == "mmdti":
        assert READ["smiles_ms"](run) == pytest.approx(_us("smiles", "smiles_bwd") / 1e3)
    else:
        assert READ["smiles_ms"](run) is None
    # every operation from the step mark to the end mark, the marks left out
    assert READ["kernels_per_step"](run) == sum(len(WORK[m]) for m in marks[:-1])
    assert READ["host_step_ms"](run) == pytest.approx(40e-3)
    # the sections and the row gather cover all of the step's device time
    # but the end section
    per_step = sum(ms for ms, _ in sections.steps(run)[0].values())
    assert per_step == pytest.approx(_us(*marks) / 1e3)


def _dropped(events, name, which):
    """The events without the ``which``-th device operation named ``name``."""
    hits = [i for i, e in enumerate(events) if e["name"] == name]
    return [e for i, e in enumerate(events) if i != hits[which]]


@pytest.mark.parametrize("fault", ["no_marks", "step_missing", "step_extra", "mark_missing",
                                   "mark_twice", "spans_missing"])
def test_h100_bench_sections_read_nothing_from_a_broken_trace(fault):
    ev = _events()
    if fault == "no_marks":
        ev = [e for e in ev if sections.PREFIX not in e["name"]]
    elif fault == "step_missing":
        ev = _dropped(ev, "trace_mark_step", 1)
    elif fault == "step_extra":
        ev = _events(steps=4)
    elif fault == "mark_missing":
        ev = _dropped(ev, "trace_mark_head_bwd", 2)
    elif fault == "mark_twice":
        i = next(i for i, e in enumerate(ev) if e["name"] == "trace_mark_optimizer")
        ev = ev[:i] + [dict(ev[i], ts=ev[i]["ts"] - 0.5)] + ev[i:]
    else:
        ev = _dropped(ev, "train.feed", 0)
    run = _Run(ev)
    device_readers = [n for n in READ if n != "host_step_ms"]
    if fault == "spans_missing":
        assert all(READ[n](run) is not None for n in device_readers)
    else:
        assert all(READ[n](run) is None for n in device_readers), fault
    assert READ["host_step_ms"](run) is None


def test_h100_bench_marks_match_no_other_reader():
    """No mark's kernel name holds a substring that the roofline readers or
    the trace's spin filter match, and the readers expect the program's
    marks."""
    parts = {trace.SPIN, "gbf_", "pair_mma_", "gbf_proj"}
    for name in REG.names("metrics"):
        mod = REG.metric(name)
        for attr in ("FWD", "BWD", "ALL"):
            parts |= set(getattr(mod, attr, ()))
    assert {"pair_mma_fwd", "pair_mma_bwd", "gbf_mma_fwd", "gbf_mma_bwd"} <= parts
    for m in MARKS:
        assert not any(p in f"trace_mark_{m}" for p in parts), m
        assert sections.mark_of(f"trace_mark_{m}") == m
    assert sections.SEQUENCES[0] == MARKS


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mmdti-train-b32-n64", "unimof-train-b16-n528"])
def test_h100_bench_replayed_feed_step_holds_each_mark_once(name):
    """A cell's traced feed steps, each a graph replay: every mark once a
    step, in order, one train.feed span a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    drv = REG.driver("train")
    r = drv.TrainRun(Cell(REG, name), 2 ** 31 + 11, "cuda")
    r.setup()
    t = r.traced()
    run = drv.Traced(r, t)
    marks = [sections.mark_of(n) for _, _, n in run.trace.device if sections.PREFIX in n]
    want = MARKS if name.startswith("mmdti") else tuple(m for m in MARKS if "smiles" not in m)
    assert marks == list(want) * t["steps"]
    assert len(sections.feed_spans_ms(run)) == t["steps"]
    assert sections.steps(run) is not None and READ["kernels_per_step"](run) > 0
    assert len(r.progs.graphs) == 1
