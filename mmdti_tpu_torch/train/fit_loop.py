"""The fit loop (port of mmdti_tpu/train/fit_loop.py on the host loader
path): epochs of train steps, the FDS epoch update, validation, the
per-epoch history, early stopping in either direction, the best
checkpoint, and the final predict from the checkpoint written.

The JAX package's K-step scans, device-resident feed, profiler hooks and
resume are left out: they change how steps are dispatched, not the numbers
(ROADMAP.md, M5).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from mmdti_tpu_torch.data.batching import MolDataLoader
from mmdti_tpu_torch.losses.fds import fds_epoch_update
from mmdti_tpu_torch.models.convert import state_dict_to_flax_params
from mmdti_tpu_torch.train.checkpointing import _write_history, save_checkpoint
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import build_eval_step, build_train_step

logger = logging.getLogger("mmdti_tpu_torch")


def weighted_loss_mean(val_losses) -> float:
    """Row-weighted mean of per-batch (loss, valid rows) pairs."""
    if not val_losses:
        return 0.0
    total_n = sum(n for _, n in val_losses)
    return float(sum(l * n for l, n in val_losses) / max(total_n, 1))


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class FitLoopMixin:
    """fit_predict; state and config live on the Trainer."""

    def fit_predict(self, model, train_dataset, valid_dataset, loss_fn, activation_fn,
                    dump_dir: str, fold: int, target_scaler, collate_fn,
                    use_infonce: bool = False, use_ct: bool = False, use_weight: bool = False,
                    fds_state=None, fds_bucket=(0.0, 1.0), fds_kernel=None,
                    fds_start_update: int = 0):
        """Train ``model`` (already on the trainer's device) and return the
        activated predictions of the best checkpoint on ``valid_dataset``."""
        train_loader = MolDataLoader(train_dataset, self.batch_size, collate_fn,
                                     shuffle=True, drop_last=True, seed=self.seed)
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0:
            raise ValueError(
                f"train set ({len(train_dataset)}) smaller than batch size {self.batch_size}")
        num_updates = max(1, steps_per_epoch * self.max_epochs)
        optimizer = FusedAdam(dict(model.named_parameters()), self.learning_rate, num_updates,
                              self.warmup_ratio, self.max_norm, mu_dtype=self.mu_dtype)
        train_step = build_train_step(model, optimizer, loss_fn, self.task,
                                      use_infonce=use_infonce, use_ct=use_ct,
                                      use_weight=use_weight, alpha=self.alpha, beta=self.beta,
                                      ct_w=self.ct_w)
        eval_step = build_eval_step(model, loss_fn, activation_fn, self.alpha)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        valid_batches = list(MolDataLoader(valid_dataset, self.batch_size, collate_fn))
        fds_batches = None

        best_params = _snapshot(model)
        best_fds = dict(fds_state) if fds_state is not None else None
        min_val_loss = float("inf")
        best_score = self.metrics.initial_best() if self.metrics else None
        use_metric_stop = isinstance(self.metrics_str, str) and self.metrics_str not in (
            "loss", "none", "")
        wait = 0
        history = []
        for epoch in range(self.max_epochs):
            t0 = time.time()
            sums, count = None, 0
            for batch, labels in train_loader:
                feats, weights = self._split_batch(batch)
                labels_d = self._labels(labels)
                m = train_step(feats, labels_d, weights, generator, fds_state=fds_state,
                               net_target=labels_d.float(), epoch=float(epoch),
                               fds_bucket=fds_bucket)
                sums = dict(m) if sums is None else {k: sums[k] + m[k] for k in sums}
                count += 1
            train_means = {k: float(v) / max(count, 1) for k, v in sums.items()}

            if self.fds and fds_state is not None and epoch >= fds_start_update:
                if fds_batches is None:
                    fds_batches = list(MolDataLoader(train_dataset, self.batch_size, collate_fn,
                                                     drop_last=True))
                pooled, label_rows = [], []
                for batch, labels in fds_batches:
                    feats, _ = self._split_batch(batch)
                    labels_d = self._labels(labels)
                    pooled.append(eval_step(feats, labels_d, labels.shape[0])[2])
                    label_rows.append(labels_d.float())
                fds_state = fds_epoch_update(
                    fds_state, torch.cat(pooled), torch.cat(label_rows), float(epoch),
                    fds_bucket[0], fds_bucket[1], fds_kernel, model.fds_cfg)
                logger.info("FDS stats updated for epoch %d", epoch)

            val_t0 = time.time()
            _, val_losses, metric_score = self.predict(
                model, valid_dataset, activation_fn, target_scaler, collate_fn,
                eval_step=eval_step, batches=valid_batches)
            val_seconds = time.time() - val_t0
            total_val_loss = weighted_loss_mean(val_losses)
            first_metric = next(iter(metric_score)) if metric_score else "loss"
            first_score = metric_score.get(first_metric, float("nan"))
            history.append({
                "epoch": epoch + 1,
                "train_loss": train_means["loss"],
                "m_loss": train_means["m_loss"],
                "infonce_loss": train_means["infonce_loss"],
                "ct_loss": train_means["ct_loss"],
                "val_loss": float(total_val_loss),
                **{f"val_{k}": float(v) for k, v in (metric_score or {}).items()},
                "seconds": round(time.time() - t0, 2),
                "val_seconds": round(val_seconds, 2),
            })
            _write_history(dump_dir, fold, history)
            logger.info(
                "Epoch [%d/%d] train_loss: %.4f, m_loss: %.4f, infonce: %.4f, ct: %.4f, "
                "val_loss: %.4f, val_%s: %.4f, %.1fs", epoch + 1, self.max_epochs,
                train_means["loss"], train_means["m_loss"], train_means["infonce_loss"],
                train_means["ct_loss"], total_val_loss, first_metric, first_score,
                time.time() - t0)

            if use_metric_stop and self.metrics:
                improved = self.metrics.is_improvement(first_score, best_score)
                if improved:
                    best_score = first_score
            else:
                improved = total_val_loss <= min_val_loss
                if improved:
                    min_val_loss = total_val_loss
            if improved:
                wait = 0
                best_params = _snapshot(model)
                best_fds = dict(fds_state) if fds_state is not None else None
            else:
                wait += 1
            if wait >= self.patience:
                logger.warning("Early stopping at epoch: %d", epoch + 1)
                break

        save_checkpoint(dump_dir, fold, state_dict_to_flax_params(best_params), best_fds)
        # the final predict reloads the artifact just written
        y_preds, _, _ = self.predict(model, valid_dataset, activation_fn, target_scaler,
                                     collate_fn, eval_step=eval_step, batches=valid_batches,
                                     load_from=(dump_dir, fold))
        return y_preds
