"""BENCHMARK.json against its files and the contract's shape; a cell, a
mix and a metric added as files and entries are found by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100_bench.registry import Cell, Registry  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
COMPARED = {"loss_gap", "grad_gap", "grad_diff", "grad_diff_median", "grad_diff_128",
            "change_gap", "change_gap_median"}
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def reg():
    return Registry()


def test_h100_bench_every_entry_has_its_file(reg):
    b = reg.bench
    assert sorted(c["name"] for c in b["configs"]) == reg.names("configs")
    assert sorted({w["traffic"] for w in b["workloads"]}) == reg.names("mixes")
    assert sorted(w["name"] for w in b["workloads"]) == reg.names("limits")
    assert sorted({reg.metric_file(m["name"]) for m in b["per_layer"]}) == reg.names("metrics")
    for c in b["configs"]:
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        assert reg.config(c["name"])["source"] == c["source"]
        assert reg.config(c["name"])["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = Cell(reg, w["name"])
        assert cell.limits and set(cell.limits) <= COMPARED
        assert cell.mix["driver"] in reg.names("drivers")


def test_h100_bench_metric_files_match_entries(reg):
    for m in reg.bench["per_layer"]:
        mod = reg.metric(m["name"])
        assert (mod.LAYER, mod.UNIT) == (m["layer"], m["unit"])


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_h100_bench_contract_shape(reg, key):
    b = reg.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in b[key]]
    assert len(names) == len(set(names))
    for e in b[key]:
        assert set(e) <= allowed[key] and NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if key in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if key == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if key == "per_layer":
            assert e["moves"] in {m["name"] for m in b["end_to_end"]}
            for w in e["workloads"]:
                assert e["moves"] in {m["name"] for m in reg.end_to_end(w)}
        if key == "workloads":
            assert e["chips"] in (1, 4) and e["config"] in {c["name"] for c in b["configs"]}
    if key == "workloads":
        for w in names:
            assert "setup_s" in {m["name"] for m in reg.end_to_end(w)}
            assert len(reg.end_to_end(w)) >= 2 and reg.per_layer(w)


def test_h100_bench_added_files_are_found(tmp_path):
    """A later change adds a mix, a cell, its limits and a per-layer metric
    as files and entries, and the harness finds each by name."""
    root = tmp_path / "h100_bench"
    shutil.copytree(os.path.join(ROOT, "h100_bench"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    mix = json.load(open(root / "mixes" / "finetune-b32-n64.json"))
    mix["batch"] = 128
    json.dump(mix, open(root / "mixes" / "finetune-b128-n64.json", "w"))
    shutil.copy(root / "limits" / "mmdti-train-b32-n64.json",
                root / "limits" / "mmdti-train-b128-n64.json")
    (root / "metrics" / "optimizer_ms.py").write_text(
        'LAYER = "optimizer"\nUNIT = "ms"\n\n\ndef read(run):\n    return run.steps * 2.0\n')
    bench["workloads"].append({"name": "mmdti-train-b128-n64", "config": "mmdti-flagship",
                               "traffic": "finetune-b128-n64", "chips": 1, "why": "larger batch"})
    bench["end_to_end"][0]["workloads"].append("mmdti-train-b128-n64")
    bench["per_layer"].append({"name": "optimizer_ms.train", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "optimizer",
                               "moves": "train_mols_per_s"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    reg = Registry(root=str(root))
    cell = Cell(reg, "mmdti-train-b128-n64")
    assert cell.mix["batch"] == 128 and cell.config["name"] == "mmdti-flagship"
    assert "finetune-b128-n64" in reg.names("mixes")
    per_layer = [m["name"] for m in reg.per_layer("mmdti-train-b128-n64")]
    assert per_layer == ["optimizer_ms.train"]
    assert "optimizer_ms.train" in [m["name"] for m in reg.per_layer("mmdti-train-b32-n64")]

    class Run:
        steps = 3

    assert reg.metric("optimizer_ms.train").read(Run()) == 6.0
