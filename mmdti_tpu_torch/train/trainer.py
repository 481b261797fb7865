"""Training orchestration (port of mmdti_tpu/train/trainer.py on one
device): the config knobs of a fit, ``fit_predict`` (train/fit_loop.py),
``predict`` over a dataset with exact handling of a padded last batch, and
``inference`` (representation extraction).

Without a mesh there is nothing to place or shard: a Trainer holds the
device its model runs on ("cuda" unless the caller asks for the CPU).
Knobs of JAX machinery that the port leaves out (resume, periodic train
state, gradient accumulation, orbax, profiling, meshes) raise when set.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from mmdti_tpu_torch.api.serve_api import resolve_device
from mmdti_tpu_torch.data.batching import MolDataLoader
from mmdti_tpu_torch.losses.registry import target_is_integer
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from mmdti_tpu_torch.train.checkpointing import load_checkpoint
from mmdti_tpu_torch.train.fit_loop import FitLoopMixin, weighted_loss_mean
from mmdti_tpu_torch.train.steps import build_eval_step
from mmdti_tpu_torch.utils.metrics import Metrics

logger = logging.getLogger("mmdti_tpu_torch")

FEATURE_KEYS = ("src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# knob -> the value that means "off"; anything else is not ported yet
_NOT_PORTED = {"resume": False, "checkpoint_interval": 0, "stop_after_epoch": 0,
               "accumulate_steps": 1, "checkpoint_backend": "msgpack", "profile_dir": None,
               "mesh_shape": None, "debug_nans": False}


def load_weights(model, dump_dir: str, fold: int):
    """Load ``model_{fold}.ckpt`` into ``model``; returns the checkpoint."""
    ckpt = load_checkpoint(dump_dir, fold)
    model.load_state_dict(flax_params_to_state_dict(ckpt["params"]), strict=True)
    return ckpt


class Trainer(FitLoopMixin):
    def __init__(self, save_path: Optional[str] = None, device="cuda", **params):
        for knob, off in _NOT_PORTED.items():
            if params.get(knob) is not None and params[knob] != off:
                raise NotImplementedError(
                    f"{knob}={params[knob]!r} is not ported yet (ROADMAP.md, M5)")
        self.save_path = save_path
        self.device = resolve_device(device)
        self.task = params.get("task", None)
        self.metrics_str = params.get("metrics", "none")
        self.metrics = Metrics(self.task, self.metrics_str) if self.task != "repr" else None
        self.seed = params.get("seed", 42)
        np.random.seed(self.seed)
        self.learning_rate = float(params.get("learning_rate", 1e-4))
        self.batch_size = int(params.get("batch_size", 32))
        self.max_epochs = int(params.get("epochs", params.get("max_epochs", 50)))
        self.warmup_ratio = float(params.get("warmup_ratio", 0.1))
        self.patience = int(params.get("patience", 10))
        self.max_norm = float(params.get("max_norm", 1.0))
        self.mu_dtype = _DTYPES[params.get("mu_dtype", "bfloat16")]
        self.alpha = float(params.get("alpha", 1))
        self.beta = float(params.get("beta", 0.1))
        self.fds = params.get("fds", False)
        self.ct_w = float(params.get("ct_w", 0.2))

    # ---- host -> device ------------------------------------------------
    def _split_batch(self, batch):
        feats = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device)
                 for k in FEATURE_KEYS}
        weights = batch.get("weights")
        if weights is not None:
            weights = torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(self.device)
        return feats, weights

    def _labels(self, labels: np.ndarray) -> torch.Tensor:
        dt = np.int64 if target_is_integer(self.task) else np.float32
        return torch.from_numpy(np.ascontiguousarray(labels, dt)).to(self.device)

    def _pad_to_batch(self, batch, labels):
        """Pad a last partial batch up to batch_size by repeating its last
        row (one static shape for every batch)."""
        n = labels.shape[0]
        if n == self.batch_size:
            return batch, labels, n
        reps = self.batch_size - n

        def pad(x):
            return np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)

        return {k: pad(v) for k, v in batch.items()}, pad(labels), n

    # ---- predict ----------------------------------------------------------
    def predict(self, model, dataset, activation_fn, target_scaler=None, collate_fn=None,
                eval_step=None, batches=None, load_from=None, loss_fn=None,
                skip_metrics: bool = False):
        """(activated predictions [n, C], per-batch (loss, rows), metrics)
        over ``dataset`` in order.  ``load_from=(dir, fold)`` first loads
        that checkpoint into ``model`` and skips the losses and metrics."""
        if load_from is not None:
            load_weights(model, *load_from)
            logger.info("load model success!")
        if eval_step is None:
            eval_step = build_eval_step(model, loss_fn, activation_fn, self.alpha)
        if batches is None:
            batches = MolDataLoader(dataset, self.batch_size, collate_fn, shuffle=False)
        eval_only = load_from is not None or skip_metrics
        preds, losses, truths = [], [], []
        for batch, labels in batches:
            batch, labels, valid_n = self._pad_to_batch(batch, labels)
            feats, _ = self._split_batch(batch)
            p, loss, _, _ = eval_step(feats, self._labels(labels), valid_n)
            preds.append(p[:valid_n])
            truths.append(labels[:valid_n])
            if not eval_only:
                losses.append((loss, valid_n))
        y_preds = torch.cat(preds).float().cpu().numpy()
        y_truths = np.concatenate(truths)
        val_losses = [(float(l), n) for l, n in losses]

        metric_score = None
        if not eval_only and self.metrics is not None:
            if self.alpha != 0:
                if target_scaler is not None and target_scaler.scaler is not None:
                    metric_score = self.metrics.cal_metric(
                        target_scaler.inverse_transform(y_truths),
                        target_scaler.inverse_transform(y_preds))
                else:
                    metric_score = self.metrics.cal_metric(y_truths, y_preds)
            else:
                metric_score = {"ct_loss": weighted_loss_mean(val_losses)}
        return y_preds, val_losses, metric_score

    @torch.no_grad()
    def inference(self, model, dataset, collate_fn, return_atomic_reprs: bool = False,
                  dictionary=None):
        """CLS-token and pooled representations per molecule and, with
        ``return_atomic_reprs``, per-atom encoder representations, the
        centered coordinates and the atom symbols."""
        result = {"cls_repr": [], "pooled_repr": [], "atomic_reprs": [],
                  "atomic_coords": [], "atomic_symbol": []}
        offset = 0
        for batch, labels in MolDataLoader(dataset, self.batch_size, collate_fn):
            batch, labels, valid_n = self._pad_to_batch(batch, labels)
            feats, _ = self._split_batch(batch)
            out = model(**feats, outputs="all")
            cls_r, pooled = out["cls_repr"].float().cpu().numpy(), out["pooled"].cpu().numpy()
            enc = out["encoder_rep"].float().cpu().numpy()
            mask = out["atom_mask"].cpu().numpy()
            result["cls_repr"].extend(list(cls_r[:valid_n]))
            result["pooled_repr"].extend(list(pooled[:valid_n]))
            if return_atomic_reprs:
                for i in range(valid_n):
                    n_valid = int(mask[i].sum())
                    result["atomic_reprs"].append(enc[i, 1:n_valid - 1])
                    sample = dataset.features[offset + i]
                    if "src_coord" in sample:
                        result["atomic_coords"].append(
                            np.asarray(sample["src_coord"], np.float32)[1:-1])
                    if dictionary is not None:
                        result["atomic_symbol"].append(
                            [dictionary[int(t)] for t in sample["src_tokens"][1:-1]])
            offset += valid_n
        return result
