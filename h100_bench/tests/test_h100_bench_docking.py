"""The docking cell's harness on the CPU: its traffic (dock_traffic.py),
the readers of its marks (dock_sections.py and the dock_* metrics) on
synthetic traces, and the comparison that decides ``correct`` against a
planted half batch and a state left unchanged, at a small size."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from small import ROOT  # noqa: F401  (puts the repo on the path)

from h100_bench import dock_sections, dock_traffic, dock_work
from h100_bench.drivers import docking as driver
from h100_bench.registry import Cell, Registry
from h100_bench.trace import Trace

CELL = "docking-train-b8-n64-p272"
REG = Registry()
SEQ = dock_sections.SEQUENCE


def small_dock() -> Cell:
    """The docking cell with every width and count cut, in float32."""
    cell = Cell(REG, CELL)
    c, m = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    for k in ("unimol", "pocket"):
        c[k].update(encoder_layers=2, embed_dim=64, ffn_embed_dim=128, attention_heads=8,
                    gaussian_kernels=16, pair_dtype="float32")
    c["compute_dtype"] = "float32"
    c["decoder"]["encoder_layers"] = 2
    m["dataset"].update(count=32, ligand_atoms=[5, 14], pocket_atoms=[20, 50])
    m.update(batch=4, atom_pad=16, pocket_pad=40, max_pocket_atoms=38, warmup_steps=1,
             trace_steps=2)
    cell.config, cell.mix = c, m
    return cell


# ---- traffic ---------------------------------------------------------------------

def _mix(count=64):
    cell = Cell(REG, CELL)
    mix = copy.deepcopy(cell.mix)
    mix["dataset"]["count"] = count
    return cell.config, mix


def test_every_seed_gets_the_same_sizes_in_another_order():
    cfg, mix = _mix()
    a = dock_traffic.complexes(cfg, mix, 3000000001)
    b = dock_traffic.complexes(cfg, mix, 2 ** 31 + 11)
    assert sorted(a["n_atoms"]) == sorted(b["n_atoms"])
    sizes = [sorted(len(s) for s in d["pocket_symbols"]) for d in (a, b)]
    assert sizes[0] == sizes[1]
    assert list(a["n_atoms"]) != list(b["n_atoms"])
    lo, hi = mix["dataset"]["ligand_atoms"]
    assert a["n_atoms"].min() >= lo + 2 and a["n_atoms"].max() <= hi + 2 <= mix["atom_pad"]
    assert max(a["n_pocket"]) <= mix["max_pocket_atoms"] + 2 <= mix["pocket_pad"]
    again = dock_traffic.complexes(cfg, mix, 3000000001)
    np.testing.assert_array_equal(a["src_coord"], again["src_coord"])
    np.testing.assert_array_equal(a["pocket_coord"][5], again["pocket_coord"][5])


def test_the_near_share_after_the_crop():
    cfg, mix = _mix()
    data = dock_traffic.complexes(cfg, mix, 3000000002)
    lo, hi = mix["dataset"]["near_share"]
    for r in range(len(data["n_atoms"])):
        n = int(data["n_atoms"][r]) - 2
        pocket = data["pocket_coord"][r]
        kept = pocket[dock_traffic.crop_order(pocket, mix["max_pocket_atoms"])]
        share = dock_traffic.near_share(data["holo"][r, 1:n + 1], kept, 8.0)
        assert 0.2 <= share <= 0.5 and lo - 0.01 <= share <= hi + 0.01, (r, share)
        # the input conformer is the holo pose moved by 0.5-1.5 A an atom
        moved = data["src_coord"][r, 1:n + 1] - data["holo"][r, 1:n + 1]
        spread = np.linalg.norm(moved - moved.mean(0), axis=1)
        assert spread.max() < 3.5


def test_flops_count_every_stack():
    cfg, _ = _mix()
    one = dock_work.forward_flops(cfg, 40, 200)
    cfg2 = copy.deepcopy(cfg)
    cfg2["recycling"] = 1
    assert dock_work.forward_flops(cfg2, 40, 200) < one
    assert dock_work.train_flops(cfg, 40, 200) == 3 * one
    assert dock_work.forward_flops(cfg, 40, 250) > one


# ---- readers on synthetic traces ------------------------------------------------

WORK = {"step": [("gather", 1.0)], "unimol": [("gbf_mma_fwd", 2.0), ("pair_mma_fwd", 3.0)],
        "pocket": [("gbf_mma_fwd", 4.0), ("pair_mma_fwd", 6.0)],
        "decoder": [("cat", 1.0), ("pair_mma_fwd", 8.0)], "dock_head": [("gemm", 10.0)],
        "head_bwd": [("fill", 0.5)], "dock_head_bwd": [("gemm", 20.0)],
        "decoder_bwd": [("pair_mma_bwd", 16.0)],
        "pocket_bwd": [("pair_mma_bwd", 12.0), ("gbf_mma_bwd", 7.0)],
        "unimol_bwd": [("pair_mma_bwd", 5.0), ("gbf_mma_bwd", 1.5)], "optimizer": [("adam", 3.0)],
        "end": [("clone", 0.5)]}
SHAPES = {"B": 8, "H": 64, "D": 8, "K": 128, "Nm": 64, "Np": 272, "Nc": 336}


FEED_US = (40.0, 30.0, 50.0)


def _events(steps=3, marks=SEQ):
    ev, t = [], 0.0

    def op(name, dur):
        nonlocal t
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": dur})
        t += dur

    op("spin_kernel", 5.0)
    for k in range(steps):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "train.feed", "ts": t,
                   "dur": FEED_US[k % len(FEED_US)]})
        for m in marks:
            op(f"trace_mark_{m}", 1.0)
            for name, dur in WORK.get(m, []):
                op(name, dur)
    op("spin_kernel", 5.0)
    return ev


class _Run:
    def __init__(self, events, steps=3):
        self.trace = Trace(events)
        self.steps = steps
        self.shapes = SHAPES


def _us(*marks):
    return sum(d for m in marks for _, d in WORK[m])


def test_section_readers_on_a_synthetic_trace():
    run = _Run(_events())
    read = {m["name"]: REG.metric(m["name"]).read for m in REG.per_layer(CELL)
            if m["name"].startswith("dock_")}
    assert read["dock_pocket_ms.train"](run) == pytest.approx(_us("pocket", "pocket_bwd") / 1e3)
    assert read["dock_decoder_ms.train"](run) == pytest.approx(
        _us("decoder", "decoder_bwd") / 1e3)
    assert read["dock_heads_ms.train"](run) == pytest.approx(
        _us("dock_head", "head_bwd", "dock_head_bwd") / 1e3)
    from h100_bench import work
    f = {n: work.pair_bias_fwd_bound(8, SHAPES[n], 64, 8)[0] for n in ("Nm", "Np", "Nc")}
    b = {n: work.pair_bias_bwd_bound(8, SHAPES[n], 64, 8, True)[0] for n in ("Nm", "Np", "Nc")}
    want = sum(f.values()) + sum(b.values())
    got_us = 3 + 6 + 8 + 16 + 12 + 5
    assert read["dock_pair_bias_roofline.train"](run) == pytest.approx(
        want / (got_us / 1e3) * 100.0)
    # every section of the step adds up to the step's device time
    split = dock_sections.steps(run)
    total = sum(d for s in split for ops in s.values() for _, d, _ in ops)
    assert total == pytest.approx(3 * sum(_us(m) for m in SEQ))


def _gbf_bound_ms():
    from h100_bench import work
    return sum(bound(8, SHAPES[n], 128, 64)[0] for n in ("Nm", "Np")
               for bound in (work.gbf_fwd_bound, work.gbf_bwd_bound))


@pytest.mark.parametrize("metric, want", [
    ("dock_optimizer_ms.train", lambda: _us("optimizer") / 1e3),
    ("dock_kernels_per_step.train",
     lambda: sum(len(WORK.get(m, [])) for m in SEQ if m != "end")),
    ("dock_host_step_ms.train", lambda: 40.0 / 1e3),
    ("dock_gbf_roofline.train",
     lambda: _gbf_bound_ms() / ((2.0 + 4.0 + 7.0 + 1.5) / 1e3) * 100.0),
])
def test_step_readers_on_a_synthetic_trace(metric, want):
    assert REG.metric(metric).read(_Run(_events())) == pytest.approx(want())


@pytest.mark.parametrize("broken", ["lost_mark", "other_model", "extra_step", "reordered"])
def test_readers_read_nothing_from_a_broken_sequence(broken):
    marks, steps = SEQ, 3
    if broken == "lost_mark":
        marks = tuple(m for m in SEQ if m != "pocket_bwd")
    elif broken == "other_model":
        marks = ("step", "unimol", "head", "head_bwd", "unimol_bwd", "optimizer", "end")
    elif broken == "reordered":
        marks = tuple(SEQ[:8]) + ("unimol_bwd", "pocket_bwd") + tuple(SEQ[10:])
    run = _Run(_events(steps, marks), steps + (1 if broken == "extra_step" else 0))
    for m in REG.per_layer(CELL):
        if m["name"].startswith("dock_"):
            assert REG.metric(m["name"]).read(run) is None, m["name"]


def test_the_cell_is_registered_with_its_metrics():
    names = {m["name"] for m in REG.per_layer(CELL)}
    assert names == {"step_device_ms.train", "step_mfu.train", "device_idle_share.train",
                     "dock_pocket_ms.train", "dock_decoder_ms.train", "dock_heads_ms.train",
                     "dock_pair_bias_roofline.train", "dock_optimizer_ms.train",
                     "dock_kernels_per_step.train", "dock_host_step_ms.train",
                     "dock_gbf_roofline.train"}
    assert {m["name"] for m in REG.end_to_end(CELL)} == {"train_mols_per_s", "setup_s"}
    assert Cell(REG, CELL).mix["driver"] == "docking"


# ---- the comparison ---------------------------------------------------------------

@pytest.fixture(scope="module")
def small_run():
    r = driver.DockRun(small_dock(), 2 ** 31 + 5, "cpu")
    r.setup()
    r.free()
    return r


def test_the_program_passes_and_the_faults_fail(small_run):
    limits = Cell(REG, CELL).limits
    ok = small_run.check()
    assert all(ok[k] <= limits[k] for k in limits), ok
    half = small_run.check(half_batch=True)
    assert any(half[k] > limits[k] for k in limits), half
    from h100_bench.reference import train as ref_train
    unchanged = dict(small_run.readings,
                     change_norms={k: 0.0 for k in small_run.readings["change_norms"]})
    gaps = ref_train.compare(unchanged, small_run.follow())
    assert gaps["change_gap"] == pytest.approx(1.0) and gaps["change_gap"] > limits["change_gap"]


def test_program_and_reference_featurize_the_same_pockets(small_run):
    from h100_bench.reference import docking as ref_docking

    host = driver.program_complexes(small_run.cfg, small_run.mix, small_run.data)
    rows = small_run.order[0]
    feats, labels = ref_docking.complex_batch(small_run.cfg, small_run.mix, small_run.data, rows)
    for k in ("pocket_src_tokens", "pocket_src_coord", "src_tokens", "src_coord"):
        np.testing.assert_allclose(host[k][rows], feats[k], atol=1e-5)
    np.testing.assert_allclose(host["labels"][rows], labels, atol=1e-4)
    assert torch.is_tensor(small_run.make_weights()["mol_model.gbf.means"])


def test_the_window_replays_one_step_a_call():
    cell = small_dock()
    cell.mix.update(warmup_steps=3)
    r = driver.DockRun(cell, 3000000007, "cpu")
    r.setup()
    assert r.next_block == cell.mix["check_steps"] + 3
    first = r.next_block
    t = r.window(0.2)
    assert t["steps"] > 0 and t["failed"] == 0
    assert r.next_block == first + t["steps"] and t["molecules"] == 4 * t["steps"]
    assert r.model_flops(first, 2) == pytest.approx(sum(
        dock_work.train_flops(cell.config, int(r.data["n_atoms"][row]),
                              int(r.data["n_pocket"][row]))
        for row in r.order[first:first + 2].reshape(-1)))
