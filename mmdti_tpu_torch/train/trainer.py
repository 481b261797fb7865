"""Training orchestration (port of mmdti_tpu/train/trainer.py): the config
knobs of a fit, ``fit_predict`` (train/fit_loop.py), ``predict`` over a
dataset with exact handling of a padded last batch (per batch from the
host, or one sweep over a device-resident dataset), and ``inference``
(representation extraction).

A Trainer holds the device its model runs on ("cuda" unless the caller
asks for the CPU).  Data and tensor parallelism are one process per GPU:
when the process belongs to a torch.distributed group
(parallel/mesh.py::initialize_distributed, or torchrun) the Trainer's
mesh is ``mesh_shape`` = (d, m) (default (world size, 1); d x m must
equal the world size), ``data_group`` and ``model_group`` its axes
(parallel/mesh.py mesh_groups: rank r is data index r // m, model index
r % m), ``device="cuda"`` means this process's card, ``batch_size`` is
the global batch, rounded up to a multiple of the data axis with the JAX
package's warning (the m model ranks of a data row take the same rows),
and the fit takes the global-batch steps of train/steps.py on a model
sharded over the model axis.  Without a group ``mesh_shape`` may only be
(1, 1).  The JAX knobs of resume and train states (``resume``,
``checkpoint_interval``, ``stop_after_epoch``, ``async_checkpoint``),
profiling (``profile_dir``, ``profile_steps``) and ``debug_nans`` work as
there; ``checkpoint_backend="orbax"`` (TPU tooling) raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mmdti_tpu_torch.data.batching import MolDataLoader
from mmdti_tpu_torch.losses.registry import target_is_integer
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from mmdti_tpu_torch.parallel.mesh import load_model_state, local_device, make_mesh, mesh_groups
from mmdti_tpu_torch.train.checkpointing import CheckpointResumeMixin, load_checkpoint
from mmdti_tpu_torch.train.device_feed import (
    FEATURE_KEYS,
    DeviceFeedMixin,
    normalize_device_feed,
)
from mmdti_tpu_torch.train.fit_loop import FitLoopMixin, weighted_loss_mean
from mmdti_tpu_torch.train.steps import build_eval_step
from mmdti_tpu_torch.utils.device import resolve_device
from mmdti_tpu_torch.utils.metrics import Metrics

logger = logging.getLogger("mmdti_tpu_torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# knob -> the value that means "off"; anything else is not ported
_NOT_PORTED = {"checkpoint_backend": ("msgpack", "orbax checkpoints are TPU tooling the port "
                                      "leaves out (ROADMAP.md, leave-behind list)")}


def load_weights(model, dump_dir: str, fold: int):
    """Load ``model_{fold}.ckpt`` into ``model`` (a model rank's shard of
    it under tensor parallelism); returns the checkpoint."""
    ckpt = load_checkpoint(dump_dir, fold)
    load_model_state(model, flax_params_to_state_dict(ckpt["params"]), strict=True)
    return ckpt


class Trainer(FitLoopMixin, DeviceFeedMixin, CheckpointResumeMixin):
    def __init__(self, save_path: Optional[str] = None, device="cuda", **params):
        for knob, (off, why) in _NOT_PORTED.items():
            if params.get(knob) is not None and params[knob] != off:
                raise NotImplementedError(f"{knob}={params[knob]!r}: {why}")
        self.save_path = save_path
        # the mesh: the processes of the group (one without a group)
        mesh_shape = params.get("mesh_shape", None)
        self.mesh = make_mesh(tuple(mesh_shape) if mesh_shape is not None else None)
        self.data_group = self.model_group = None
        if dist.is_initialized():
            world = dist.get_world_size()
            if self.mesh.data * self.mesh.model != world:
                raise ValueError(f"mesh_shape {tuple(mesh_shape)}: a fit's data axis times its "
                                 f"model axis is its {world} processes, one per GPU")
            self.data_group, self.model_group = mesh_groups(self.mesh)
            if torch.device(device) == torch.device("cuda"):
                device = local_device()
        self.device = resolve_device(device)
        self.task = params.get("task", None)
        self.metrics_str = params.get("metrics", "none")
        self.metrics = Metrics(self.task, self.metrics_str) if self.task != "repr" else None
        self.seed = params.get("seed", 42)
        np.random.seed(self.seed)
        self.learning_rate = float(params.get("learning_rate", 1e-4))
        self.batch_size = int(params.get("batch_size", 32))
        # every batch is the global batch, its rows split evenly over the
        # data axis
        data_par = self.mesh.data
        if self.batch_size % data_par:
            rounded = -(-self.batch_size // data_par) * data_par
            logger.warning("batch_size %d is not divisible by the %d-way data mesh axis; "
                           "rounding up to %d", self.batch_size, data_par, rounded)
            self.batch_size = rounded
        self.max_epochs = int(params.get("epochs", params.get("max_epochs", 50)))
        self.warmup_ratio = float(params.get("warmup_ratio", 0.1))
        self.patience = int(params.get("patience", 10))
        self.max_norm = float(params.get("max_norm", 1.0))
        self.mu_dtype = _DTYPES[params.get("mu_dtype", "bfloat16")]
        self.alpha = float(params.get("alpha", 1))
        self.beta = float(params.get("beta", 0.1))
        self.fds = params.get("fds", False)
        self.ct_w = float(params.get("ct_w", 0.2))
        # train steps per dispatch: one CUDA graph holds this many (the JAX
        # package's lax.scan programs; train/fit_loop.py says why the port
        # does not default to the whole epoch)
        spc = params.get("steps_per_call", None)
        self.steps_per_call_explicit = spc is not None
        self.steps_per_call = int(spc if spc is not None else 4) or 1
        # the device-resident feed: 'auto' (static padding and the resident
        # bytes within device_feed_bytes), True or False; any other
        # spelling raises
        self.device_feed = normalize_device_feed(params.get("device_feed", "auto"))
        self.device_feed_bytes = int(params.get("device_feed_bytes", 1 << 30))
        # gradient accumulation (optax.MultiSteps): k mini-batches average
        # into one update; batch-coupled losses (InfoNCE negatives, CT
        # pairs) see the mini-batch
        self.accumulate_steps = int(params.get("accumulate_steps", 1) or 1)
        # train states (train/checkpointing.py): every checkpoint_interval
        # epochs (0: never) and at stop_after_epoch (an absolute 1-based
        # epoch; 0: none), written on a background thread unless
        # async_checkpoint is off; resume continues from one
        self.checkpoint_interval = int(params.get("checkpoint_interval", 0) or 0)
        self.stop_after_epoch = int(params.get("stop_after_epoch", 0) or 0)
        self.async_checkpoint = bool(params.get("async_checkpoint", True))
        self.resume = bool(params.get("resume", False))
        self.state_saves = []
        # a trace of the first profile_steps dispatches into profile_dir
        # (train/profiler.py); debug_nans checks every dispatch's losses and
        # gradient norm
        self.profile_dir = params.get("profile_dir", None)
        self.profile_steps = int(params.get("profile_steps", 5) or 5)
        self.debug_nans = bool(params.get("debug_nans", False))
        self._sweeps = {}
        # the last fit's TrainPrograms and the fit's resident datasets by
        # slot, which the next fold of a cross-validation reuses
        self._last_programs = None
        self._slots = {}
        self.programs_built = 0

    # ---- host -> device ------------------------------------------------
    def _feature_arrays(self, batch):
        """A collated batch's model inputs and sample weights (or None) as
        the contiguous arrays the device receives."""
        feats = {k: np.ascontiguousarray(batch[k]) for k in FEATURE_KEYS if k in batch}
        weights = batch.get("weights")
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32)
        return feats, weights

    def _label_array(self, labels: np.ndarray) -> np.ndarray:
        dt = np.int64 if target_is_integer(self.task) else np.float32
        return np.ascontiguousarray(labels, dt)

    def _split_batch(self, batch):
        feats, weights = self._feature_arrays(batch)
        feats = {k: torch.from_numpy(v).to(self.device) for k, v in feats.items()}
        if weights is not None:
            weights = torch.from_numpy(weights).to(self.device)
        return feats, weights

    def _labels(self, labels: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self._label_array(labels)).to(self.device)

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
                skip_metrics: bool = False, device_data=None):
        """(activated predictions [n, C], per-batch (loss, rows), metrics)
        over ``dataset`` in order.  ``load_from=(dir, fold)`` first loads
        that checkpoint into ``model`` and skips the losses and metrics.
        ``device_data`` (build_eval_device_data) sweeps the resident
        dataset instead of collating batches on the host."""
        if load_from is not None:
            load_weights(model, *load_from)
            logger.info("load model success!")
        eval_only = load_from is not None or skip_metrics
        if device_data is not None:
            valid_ns = device_data["valid_ns"]
            preds_nb, losses_nb = device_data["eval_sweep"](
                device_data["resident"], device_data["idx"], device_data["valid_ns_dev"])
            preds_h = preds_nb.float().cpu().numpy()
            y_preds = np.concatenate([preds_h[i, :n] for i, n in enumerate(valid_ns)])
            y_truths = device_data["labels_host"]
            val_losses = [] if eval_only else list(zip(losses_nb.tolist(), valid_ns))
        else:
            if eval_step is None:
                eval_step = build_eval_step(model, loss_fn, activation_fn, self.alpha)
            if batches is None:
                batches = MolDataLoader(dataset, self.batch_size, collate_fn, shuffle=False)
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
            # multiclass log loss pins its labels to the model's classes
            label_cnt = model.output_dim if self.task == "multiclass" else None
            if self.alpha != 0:
                if target_scaler is not None and target_scaler.scaler is not None:
                    metric_score = self.metrics.cal_metric(
                        target_scaler.inverse_transform(y_truths),
                        target_scaler.inverse_transform(y_preds), label_cnt=label_cnt)
                else:
                    metric_score = self.metrics.cal_metric(y_truths, y_preds,
                                                           label_cnt=label_cnt)
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
