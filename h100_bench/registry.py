"""Everything a run needs, found by name: BENCHMARK.json's entries, and
under this folder ``configs/<config>.json``, ``mixes/<traffic>.json``,
``limits/<workload>.json``, ``metrics/<metric>.py`` and
``drivers/<driver>.py`` (the driver a mix names).  Adding a cell, a
configuration, a mix, a metric or a driver is adding files and entries.

A per-layer metric ``<quantity>.<part>`` (``step_mfu.train``), split by
the end-to-end metric it moves, is read by ``metrics/<quantity>.<part>.py``
where that file exists, and otherwise by ``metrics/<quantity>.py``."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Registry:
    def __init__(self, root: Optional[str] = None):
        """``root``: the folder that holds configs/, mixes/, ... (this one
        by default), with BENCHMARK.json beside it."""
        self.root = root or HERE
        self.bench_path = os.path.join(os.path.dirname(self.root), "BENCHMARK.json")
        with open(self.bench_path) as f:
            self.bench = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.root, kind, name + ".json")) as f:
            return json.load(f)

    def names(self, kind: str) -> List[str]:
        """The names of the files of a kind (configs, mixes, limits,
        metrics, drivers) in this folder."""
        ext = ".py" if kind in ("metrics", "drivers") else ".json"
        return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(self.root, kind))
                      if f.endswith(ext) and not f.startswith("_"))

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.bench_path}")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("mixes", name)

    def limits(self, workload: str) -> Dict[str, float]:
        return {k: v["limit"] for k, v in self._json("limits", workload)["checks"].items()}

    def _module(self, kind: str, name: str):
        path = os.path.join(self.root, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metric_file(self, name: str) -> str:
        """The reader file's name (without ``.py``) of a per-layer metric."""
        metrics = self.names("metrics")
        if name in metrics:
            return name
        quantity = name.split(".")[0]
        if quantity in metrics:
            return quantity
        raise KeyError(f"no reader metrics/{name}.py or metrics/{quantity}.py")

    def metric(self, name: str):
        """The reader module of a per-layer metric: LAYER, UNIT and
        ``read(run) -> float or None``."""
        return self._module("metrics", self.metric_file(name))

    def driver(self, name: str):
        """A driver module: ``run(cell, seed, seconds, trace) -> Result``."""
        return self._module("drivers", name)

    def _for_cell(self, entries: List[dict], workload: str, reported=None) -> List[dict]:
        out = []
        for e in entries:
            if "workloads" in e:
                if workload in e["workloads"]:
                    out.append(e)
            elif reported is None or e["moves"] in reported:
                out.append(e)
        return out

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics a cell reports."""
        return self._for_cell(self.bench["end_to_end"], workload)

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics a cell's traced run reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return self._for_cell(self.bench["per_layer"], workload, reported)


class Cell:
    """One workload with its configuration, mix and limits."""

    def __init__(self, registry: Registry, workload: str):
        self.registry = registry
        self.workload = registry.workload(workload)
        self.name = workload
        self.config = registry.config(self.workload["config"])
        self.mix = registry.mix(self.workload["traffic"])
        self.limits = registry.limits(workload)
        self.chips = self.workload["chips"]
