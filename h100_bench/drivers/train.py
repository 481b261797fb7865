"""Driver of the fine-tune mixes: mmdti_tpu_torch's training step
(``train/steps.py`` TrainPrograms.feed over a Resident data set, with the
``train/optim.py`` FusedAdam update) on data made from the seed.

Set-up builds the model on the device, loads the benchmark's weights
(reference/model.py make_weights, drawn on the device from the seed),
builds one optimizer and one TrainPrograms, puts the data set on the
device and drives the first ``check_steps`` steps through ``feed`` on rows
that all differ, reading the losses, the first gradient (from Adam's
second moment after step 1, unclipped by the step's global norm) and the
parameters' change after the last of them.  Each ``feed`` call is one
step replayed from one CUDA graph, so that the optimizer's state after
step 1 can be read; the host only replays, and runs ahead of the card.
Where the harness gives ``opens_at``, the steps replay on as warm-up
until then.  Then the window replays steps, one epoch's permutation after another,
until ``seconds`` have passed on the host clock, and ends on a device
synchronise.  A traced run profiles ``trace_steps`` steps instead.  Once
the window has closed and the peak memory is read, the program is freed
and the reference follows the checked steps from the same weights,
batches and dropout seed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from h100_bench import traffic, work
from h100_bench.reference import featurize
from h100_bench.reference import train as ref_train
from h100_bench.reference.model import make_weights


def _program_model(cfg: dict, dev):
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.models.mof import build_mof_model

    u = {k: v for k, v in cfg["unimol"].items()}
    common = dict(compute_dtype=cfg["compute_dtype"], use_kernels=True, unimol_overrides=u)
    with torch.device(dev):
        if cfg["model"] == "mof":
            g = cfg["gas_env"]
            mof = {k: g[k] for k in ("gas_attr_input_dim", "gas_dim", "gas_max_count", "env_bins")}
            mof["env_min_max"] = {k: tuple(v) for k, v in g["env_min_max"].items()}
            return build_mof_model(cfg["output_dim"], len(cfg["atom_vocab"]), cfg["atom_pad_idx"],
                                   "regression", mof_overrides=mof, **common)
        c = {k: v for k, v in cfg["chemberta"].items()}
        return build_model(cfg["output_dim"], len(cfg["atom_vocab"]), cfg["atom_pad_idx"],
                           c["vocab_size"], chemberta_overrides=c,
                           crossmodal_overrides=dict(cfg["crossmodal"]), task="regression",
                           **common)


def _program_crystals(cfg: dict, mix: dict, data: dict) -> Dict[str, np.ndarray]:
    """The program's featurization of the crystals (chem/mof.py
    coords2unimol_mof, the port's dictionary), padded by the benchmark."""
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.mof import coords2unimol_mof

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    if [d[i] for i in range(len(d))] != cfg["atom_vocab"]:
        raise ValueError("the program's atom dictionary is not the configuration's")
    R, N = len(data["symbols"]), mix["atom_pad"]
    tokens = np.full((R, N), cfg["atom_pad_idx"], np.int64)
    coords = np.zeros((R, N, 3), np.float32)
    for r in range(R):
        f = coords2unimol_mof(data["symbols"][r], data["coords"][r], d,
                              max_atoms=mix["max_atoms"],
                              crop_rng=np.random.RandomState(data["crop_seeds"][r]))
        n = len(f["src_tokens"])
        tokens[r, :n] = f["src_tokens"]
        coords[r, :n] = f["src_coord"]
    return {"src_tokens": tokens, "src_coord": coords, "gas_id": data["gas_id"],
            "gas_attr": data["gas_attr"], "pressure": data["pressure"],
            "temperature": data["temperature"]}


def _frozen(model, mix):
    from mmdti_tpu_torch.train.nnmodel import frozen_parameter_names

    f = mix.get("freeze") or {}
    return frozen_parameter_names(model, f.get("layers"), f.get("reversed", False),
                                  f.get("module"))


class TrainRun:
    """One run of a fine-tune cell; ``setup`` then ``window`` or ``traced``,
    then ``check``."""

    def __init__(self, cell, seed: int, device="cuda"):
        self.cfg, self.mix = cell.config, cell.mix
        if tuple(self.mix.get("mesh", (1, 1))) != (1, 1):
            raise NotImplementedError("the train driver runs mesh (1, 1) only")
        self.seed = int(seed)
        self.dev = torch.device(device)

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from mmdti_tpu_torch.losses import zoo
        from mmdti_tpu_torch.train.optim import FusedAdam
        from mmdti_tpu_torch.train.steps import Resident, TrainPrograms

        cfg, mix, dev = self.cfg, self.mix, self.dev
        self.phases = {}
        t0 = time.perf_counter()
        kind = mix["dataset"]["kind"]
        if kind == "molecules":
            self.data = traffic.molecules(cfg, mix, self.seed)
            host = {k: self.data[k] for k in ("src_tokens", "src_coord", "input_ids",
                                               "attention_mask")}
        elif kind == "crystals":
            self.data = traffic.crystals(cfg, mix, self.seed)
            host = _program_crystals(cfg, mix, self.data)
        else:
            raise ValueError(f"dataset kind {kind!r}")
        self.rows = len(self.data["labels"])
        self.phases["data_s"] = time.perf_counter() - t0
        self.weights = self.make_weights()
        model = _program_model(cfg, dev)
        model.load_state_dict(self.weights, strict=True)
        self.frozen = _frozen(model, mix)
        for n, p in model.named_parameters():
            p.requires_grad_(n not in self.frozen)
        o = mix["optimizer"]
        self.opt = FusedAdam(dict(model.named_parameters()), o["learning_rate"],
                             o["schedule_steps"], warmup_ratio=o["warmup_ratio"],
                             max_norm=o["max_norm"], frozen=self.frozen)
        self.dropout_seed = traffic.derived_seed(self.seed, "dropout")
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.dropout_seed)
        loss = mix["loss"]
        self.progs = TrainPrograms(model, self.opt, zoo.mse_loss, "regression", gen,
                                   use_infonce=loss["infonce"], use_ct=loss["ct"],
                                   use_weight=False, alpha=loss["alpha"], beta=loss["beta"],
                                   ct_w=loss["ct_w"])
        feats = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        self.resident = Resident(feats, torch.from_numpy(self.data["labels"]).to(dev), None)
        B = mix["batch"]
        epochs = mix["epochs_drawn"]
        self.order = traffic.epoch_orders(self.rows, B, epochs, self.seed)
        self.blocks = torch.from_numpy(self.order).to(dev).view(-1, 1, B)
        self.next_block = 0
        self.phases["model_s"] = time.perf_counter() - t0 - self.phases["data_s"]
        self.readings = self._check_steps()
        # drawn again for the reference once the program is freed
        self.weights = None
        for _ in range(mix["warmup_steps"]):
            self._step()
        self._sync()
        self.phases["steps_s"] = time.perf_counter() - t0 - sum(self.phases.values())

    def make_weights(self) -> Dict[str, torch.Tensor]:
        """The weights of this seed, drawn on the device."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(traffic.derived_seed(self.seed, "weights"))
        return make_weights(self.cfg, gen)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self):
        i = self.next_block % len(self.blocks)
        self.next_block += 1
        return self.progs.feed(self.resident, self.blocks[i])

    def _check_steps(self) -> dict:
        """The program's readings over its first steps (the first recording
        the step's graph)."""
        from mmdti_tpu_torch.train.steps import METRICS

        n = self.mix["check_steps"]
        opt = self.opt
        losses, grads = [], None
        for k in range(n):
            m = self._step()
            losses.append(float(m[0, METRICS.index("loss")]))
            if k == 0:
                # Adam's second moment after one step is (1 - b2) g^2 of the
                # clipped gradient; the step's global norm undoes the clip
                # and the first moment, (1 - b1) g in bfloat16, its sign
                unclip = max(1.0, float(m[0, METRICS.index("grad_norm")]) / opt.max_norm)
                state = opt.state
                grads = {name: (torch.sqrt(state.nu[name] / (1 - opt.b2)) * unclip
                                * torch.sign(state.mu[name].float())).cpu()
                         for name in opt.params if name not in self.frozen}
        with torch.no_grad():
            change = {name: float(torch.linalg.norm(opt.params[name] - self.weights[name]))
                      for name in opt.params if name not in self.frozen}
        return {"losses": losses, "grads": grads, "change_norms": change}

    def settle(self, opens_at: float, clock):
        """Warm-up steps until ``clock()`` reaches ``opens_at``."""
        t0 = time.perf_counter()
        while clock() < opens_at:
            self._step()
        self._sync()
        self.phases["settle_s"] = time.perf_counter() - t0

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed, ending on a synchronise."""
        outs = []
        first = self.next_block
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            outs.append(self._step())
        self._sync()
        t1 = time.perf_counter()
        steps = len(outs)
        losses = torch.cat(outs)[:, 0]
        failed = int((~torch.isfinite(losses)).sum())
        return {"steps": steps, "window_s": t1 - t0, "failed": failed,
                "molecules": steps * self.mix["batch"], "first_block": first}

    def traced(self) -> dict:
        """``trace_steps`` steps under the profiler."""
        from h100_bench.trace import traced

        n = self.mix["trace_steps"]
        first = self.next_block
        outs = []

        def run():
            for _ in range(n):
                outs.append(self._step())

        tr = traced(run, self._sync)
        losses = torch.cat(outs)[:, 0]
        return {"steps": n, "trace": tr, "failed": int((~torch.isfinite(losses)).sum()),
                "molecules": n * self.mix["batch"], "first_block": first}

    def model_flops(self, first_block: int, steps: int) -> float:
        """Train FLOPs of the molecules of ``steps`` steps from
        ``first_block``, at their real sizes."""
        n_atoms = self.data["n_atoms"]
        n_tok = self.data.get("n_tokens")
        rows = self.order[[(first_block + s) % len(self.order) for s in range(steps)]].reshape(-1)
        return sum(work.train_flops(self.cfg, int(n_atoms[r]),
                                    0 if n_tok is None else int(n_tok[r])) for r in rows)

    # -- correctness ------------------------------------------------------------

    def free(self):
        """Drop the program (model, optimizer, graphs, resident data)."""
        self.progs = self.opt = self.resident = self.blocks = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self):
        cfg, mix, dev = self.cfg, self.mix, self.dev
        out = []
        for k in range(mix["check_steps"]):
            rows = self.order[k]
            if mix["dataset"]["kind"] == "crystals":
                host = featurize.crystal_batch(cfg, self.data, rows, mix["max_atoms"],
                                               mix["atom_pad"])
            else:
                host = {key: self.data[key][rows] for key in ("src_tokens", "src_coord",
                                                              "input_ids", "attention_mask")}
            feats = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for key, v in host.items()}
            out.append((feats, torch.from_numpy(self.data["labels"][rows]).to(dev)))
        return out

    def check(self, precision: str = "float32", worst: Optional[dict] = None,
              **fault) -> Dict[str, float]:
        """The reference's readings against the program's: the numbers
        compared (reference/train.py compare; ``worst`` gets what set
        each)."""
        ref = ref_train.follow(self.cfg, self.mix, self.make_weights(), self.reference_batches(),
                               self.dropout_seed, self.frozen, precision, **fault)
        return ref_train.compare(self.readings, ref, worst=worst)


class Traced:
    """What a per-layer metric reads of a traced run: the trace, the steps
    traced, their model FLOPs and the shapes the kernels were handed."""

    def __init__(self, r: TrainRun, t: dict):
        self.trace, self.steps = t["trace"], t["steps"]
        self.flops = r.model_flops(t["first_block"], t["steps"])
        u = r.cfg["unimol"]
        self.shapes = {"B": r.mix["batch"], "N": r.mix["atom_pad"], "H": u["attention_heads"],
                       "D": u["embed_dim"] // u["attention_heads"], "K": u["gaussian_kernels"],
                       "layers": u["encoder_layers"]}


def run(cell, seed: int, seconds: float, trace: bool, start: float, clock,
        device="cuda", opens_at: float = 0.0) -> dict:
    """One run: set-up, warm-up steps until ``opens_at``, the window (or the
    traced steps), the check.  ``start`` and ``opens_at`` are on
    ``clock``."""
    r = TrainRun(cell, seed, device)
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
