"""Driver of the docking mixes: mmdti_tpu_torch's binding-pose model
(``models/docking.py``) trained through ``train/steps.py`` TrainPrograms.feed
over a Resident data set of complexes, with the ``train/optim.py``
FusedAdam update, on data made from the seed (dock_traffic.py).

The run is drivers/train.py's, one step a feed call throughout: set-up
builds the model on the device, loads the benchmark's weights
(reference/docking.py make_weights, drawn on the device from the seed),
featurizes the pockets with the program's own crop (chem/pocket.py) and
its distance targets, puts the complexes on the device, drives the first
``check_steps`` steps and reads their losses, first gradient and
parameters' change; the warm-up, the window and the traced steps replay
the same step's graph.  The program is then freed and the reference
(reference/docking.py, with its own crop and targets) follows the checked
steps from the same weights, batches and dropout seed.  Adam takes the
mix's ``betas``.  A checkout without the docking model fails at this
module's import, before any set-up.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from mmdti_tpu_torch.models.docking import build_docking_model

from h100_bench import dock_traffic, dock_work, traffic
from h100_bench.drivers.train import TrainRun
from h100_bench.reference import docking as ref_docking
from h100_bench.reference import train as ref_train


def program_complexes(cfg: dict, mix: dict, data: dict) -> Dict[str, np.ndarray]:
    """The program's featurization of the pockets (chem/pocket.py: crop,
    tokens under its pocket dictionary, centred coordinates) and of the
    distance targets (chem/pocket.py docking_targets, data/batching.py
    docking_labels), padded by the benchmark."""
    from mmdti_tpu_torch.chem.pocket import docking_targets, pocket_dictionary, pocket_features
    from mmdti_tpu_torch.data.batching import docking_labels

    d = pocket_dictionary()
    if [d[i] for i in range(len(d))] != cfg["pocket_vocab"]:
        raise ValueError("the program's pocket dictionary is not the configuration's")
    R, Np = len(data["src_tokens"]), mix["pocket_pad"]
    tokens = np.full((R, Np), cfg["pocket_pad_idx"], np.int64)
    coords = np.zeros((R, Np, 3), np.float32)
    features = []
    for r in range(R):
        f = pocket_features(data["pocket_symbols"][r], data["pocket_coord"][r], d,
                            mix["max_pocket_atoms"])
        n = len(f["pocket_src_tokens"])
        tokens[r, :n] = f["pocket_src_tokens"]
        coords[r, :n] = f["pocket_src_coord"]
        m = int(data["n_atoms"][r]) - 2
        features.append(docking_targets(data["holo"][r, 1:m + 1], f["pocket_coord"]))
    return {"src_tokens": data["src_tokens"], "src_coord": data["src_coord"],
            "pocket_src_tokens": tokens, "pocket_src_coord": coords,
            "labels": docking_labels(features, mix["atom_pad"], Np)}


class DockRun(TrainRun):
    """One run of a docking cell: TrainRun's steps, window, trace and
    readings over the docking model and its complexes."""

    def setup(self):
        from mmdti_tpu_torch.losses import zoo
        from mmdti_tpu_torch.train.optim import FusedAdam
        from mmdti_tpu_torch.train.steps import Resident, TrainPrograms

        cfg, mix, dev = self.cfg, self.mix, self.dev
        if mix["dataset"]["kind"] != "complexes":
            raise ValueError(f"dataset kind {mix['dataset']['kind']!r}")
        self.phases = {}
        t0 = time.perf_counter()
        self.data = dock_traffic.complexes(cfg, mix, self.seed)
        host = program_complexes(cfg, mix, self.data)
        labels = host.pop("labels")
        self.rows = len(labels)
        self.phases["data_s"] = time.perf_counter() - t0
        self.weights = self.make_weights()
        with torch.device(dev):
            model = build_docking_model(
                len(cfg["atom_vocab"]), cfg["atom_pad_idx"], len(cfg["pocket_vocab"]),
                cfg["pocket_pad_idx"], cfg["compute_dtype"], True, dict(cfg["unimol"]),
                dict(cfg["pocket"]), cfg["decoder"]["encoder_layers"], cfg["recycling"])
        model.load_state_dict(self.weights, strict=True)
        self.frozen = frozenset()
        o = mix["optimizer"]
        b1, b2 = o["betas"]
        self.opt = FusedAdam(dict(model.named_parameters()), o["learning_rate"],
                             o["schedule_steps"], warmup_ratio=o["warmup_ratio"],
                             max_norm=o["max_norm"], b1=b1, b2=b2)
        self.dropout_seed = traffic.derived_seed(self.seed, "dropout")
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.dropout_seed)
        self.progs = TrainPrograms(model, self.opt, zoo.docking_pose_loss, "docking", gen,
                                   use_infonce=False, use_ct=False, use_weight=False)
        feats = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        self.resident = Resident(feats, torch.from_numpy(labels).to(dev), None)
        B = mix["batch"]
        self.order = traffic.epoch_orders(self.rows, B, mix["epochs_drawn"], self.seed)
        self.blocks = torch.from_numpy(self.order).to(dev).view(-1, 1, B)
        self.next_block = 0
        self.phases["model_s"] = time.perf_counter() - t0 - self.phases["data_s"]
        self.readings = self._check_steps()
        self.weights = None
        for _ in range(mix["warmup_steps"]):
            self._step()
        self._sync()
        self.phases["steps_s"] = time.perf_counter() - t0 - sum(self.phases.values())

    def make_weights(self) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(traffic.derived_seed(self.seed, "weights"))
        return ref_docking.make_weights(self.cfg, gen)

    def model_flops(self, first_block: int, steps: int) -> float:
        """Train FLOPs of the complexes of ``steps`` steps from
        ``first_block``, at their real sizes."""
        rows = self.order[[(first_block + s) % len(self.order) for s in range(steps)]].reshape(-1)
        return sum(dock_work.train_flops(self.cfg, int(self.data["n_atoms"][r]),
                                         int(self.data["n_pocket"][r])) for r in rows)

    def reference_batches(self):
        out = []
        for k in range(self.mix["check_steps"]):
            feats, labels = ref_docking.complex_batch(self.cfg, self.mix, self.data, self.order[k])
            out.append(({key: torch.from_numpy(np.ascontiguousarray(v)).to(self.dev)
                         for key, v in feats.items()}, torch.from_numpy(labels).to(self.dev)))
        return out

    def follow(self, batches=None, precision: str = "float32", **fault) -> dict:
        """The reference's readings over the checked steps."""
        return ref_docking.follow(self.cfg, self.mix, self.make_weights(),
                                  batches or self.reference_batches(), self.dropout_seed,
                                  self.frozen, precision, **fault)

    def check(self, precision: str = "float32", worst: Optional[dict] = None,
              **fault) -> Dict[str, float]:
        return ref_train.compare(self.readings, self.follow(precision=precision, **fault),
                                 worst=worst)


class Traced:
    """What a per-layer metric reads of a traced docking run: the trace, the
    steps traced, their model FLOPs and the shapes the kernels were handed
    (B, H, D, and N of the ligand, the pocket and the complex)."""

    def __init__(self, r: DockRun, t: dict):
        self.trace, self.steps = t["trace"], t["steps"]
        self.flops = r.model_flops(t["first_block"], t["steps"])
        u = r.cfg["unimol"]
        Nm, Np = r.mix["atom_pad"], r.mix["pocket_pad"]
        self.shapes = {"B": r.mix["batch"], "H": u["attention_heads"],
                       "D": u["embed_dim"] // u["attention_heads"], "K": u["gaussian_kernels"],
                       "Nm": Nm, "Np": Np, "Nc": Nm + Np}


def run(cell, seed: int, seconds: float, trace: bool, start: float, clock,
        device="cuda", opens_at: float = 0.0) -> dict:
    """One run: set-up, warm-up steps until ``opens_at``, the window (or the
    traced steps), the check.  ``start`` and ``opens_at`` are on
    ``clock``."""
    r = DockRun(cell, seed, device)
    r.setup()
    r.settle(opens_at, clock)
    out = {"e2e": {"setup_s": clock() - start}}
    if trace:
        t = r.traced()
        out["traced"] = Traced(r, t)
    else:
        t = r.window(seconds)
        out["e2e"]["train_mols_per_s"] = t["molecules"] / t["window_s"]
    out.update(attempted=t["steps"], failed=t["failed"])
    if r.dev.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(r.dev))
    r.free()
    out["worst"] = {}
    t0 = time.perf_counter()
    out["checks"] = r.check(worst=out["worst"])
    out["phases"] = {**r.phases, "check_s": time.perf_counter() - t0}
    return out
