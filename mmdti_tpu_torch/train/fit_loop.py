"""The fit loop (port of mmdti_tpu/train/fit_loop.py): epochs of train
dispatches, the FDS epoch update, validation, the per-epoch history, early
stopping in either direction, the best checkpoint, and the final predict
from the checkpoint written.

With the device-resident feed (train/device_feed.py) an epoch is [K, B]
index blocks of ``MolDataLoader.epoch_index_matrix``, K steps each, and
validation and the FDS pass sweep the resident arrays; without it, K
shape-equal host batches are stacked per dispatch and any left over run
one step at a time.  On a CUDA device a K-step dispatch and a sweep's
batch are CUDA graph replays (train/steps.py).  Dispatch grouping never
changes the math: the same batches in the same order, the same dropout
draws from the fit's generator.

Cross-validation calls fit_predict once a fold.  A fold whose train
programs would be the same as the last fold's (the same model, losses,
schedule length and flags) reuses them: the optimizer's moments and
counts go back to zero in place, the generator to its seed, the FDS and
loss state to their start, and its datasets are copied into the last
fold's resident arrays when their shapes agree, so the CUDA graphs
recorded for the first fold replay for the next.  The hooks of
train/checkpointing.py (resume, periodic and stop-after train states) and
train/profiler.py (a trace of the first dispatches, the dispatch timer)
run where the JAX loop runs them; ``debug_nans`` checks each dispatch's
losses and gradient norms.

Under data parallelism (the Trainer's ``data_group``) every rank runs this
loop on the same global batches: it takes its own rows of each (the
columns of the index block that are its, or its rows of a host batch
collated whole, so every rank pads to the global batch's lengths), starts
from rank 0's parameters and optimizer state and draws dropout from its
own generator.  The FDS pass and validation run whole on every rank, so
the FDS statistics, the history, the early stop and the best weights are
the same everywhere; only rank 0 writes (train/checkpointing.py), and the
final predict evaluates the best weights in memory on every rank instead
of reloading the checkpoint rank 0 wrote.  Under tensor parallelism (the
Trainer's ``model_group``) the m model ranks of a data row take the same
rows and share its dropout stream (``rank_seed`` of the data index); the
checkpoint and the train state hold the whole model, gathered over the
model group before rank 0 writes, and a resume cuts them to each rank's
shard again.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from mmdti_tpu_torch.data.batching import CachedLoader, MolDataLoader
from mmdti_tpu_torch.data.pipeline import StreamPut, prefetch_to_device
from mmdti_tpu_torch.losses.fds import fds_epoch_update
from mmdti_tpu_torch.models.convert import state_dict_to_flax_params
from mmdti_tpu_torch.parallel.mesh import (
    barrier,
    is_writer_process,
    model_shard,
    model_state,
    rank_seed,
)
from mmdti_tpu_torch.train.checkpointing import (
    _AsyncSaver,
    _load_history,
    _write_history,
    save_checkpoint,
)
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.profiler import DispatchProfiler
from mmdti_tpu_torch.train.steps import METRICS, TrainPrograms, build_eval_step

logger = logging.getLogger("mmdti_tpu_torch")

_CHECKED = [METRICS.index("loss"), METRICS.index("grad_norm")]


def weighted_loss_mean(val_losses) -> float:
    """Row-weighted mean of per-batch (loss, valid rows) pairs."""
    if not val_losses:
        return 0.0
    total_n = sum(n for _, n in val_losses)
    return float(sum(l * n for l, n in val_losses) / max(total_n, 1))


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _clone(state):
    return None if state is None else {k: v.clone() for k, v in state.items()}


def _snap_to_divisor(k: int, nb: int) -> int:
    """The largest divisor of nb that is at most k (and at least 1)."""
    k = max(1, min(k, nb))
    return next(d for d in range(k, 0, -1) if nb % d == 0)


def check_finite(metrics: torch.Tensor, epoch: int, first_step: int) -> None:
    """debug_nans: raise FloatingPointError naming the epoch (1-based) and
    the global step of the first step of a dispatch whose loss or gradient
    norm is not finite (``metrics`` [M] or [K, M])."""
    rows = metrics.reshape(-1, len(METRICS))[:, _CHECKED]
    bad = torch.nonzero(~torch.isfinite(rows).all(dim=1)).flatten().tolist()
    if bad:
        row = rows[bad[0]].tolist()
        raise FloatingPointError(
            f"debug_nans: non-finite loss or gradient norm at epoch {epoch + 1}, step "
            f"{first_step + bad[0]} (loss {row[0]}, grad_norm {row[1]})")


class FitLoopMixin:
    """fit_predict; state and config live on the Trainer."""

    def fit_predict(self, model, train_dataset, valid_dataset, loss_fn, activation_fn,
                    dump_dir: str, fold: int, target_scaler, collate_fn,
                    use_infonce: bool = False, use_ct: bool = False, use_weight: bool = False,
                    fds_state=None, fds_bucket=(0.0, 1.0), fds_kernel=None,
                    fds_start_update: int = 0, stateful_loss=None, frozen=frozenset()):
        """Train ``model`` (already on the trainer's device) and return the
        activated predictions of the best checkpoint on ``valid_dataset``.
        ``stateful_loss`` (GHMCState) replaces ``loss_fn`` in the train
        steps, from a fresh state; validation keeps ``loss_fn``.
        ``frozen`` names the parameters that must not move (their
        ``requires_grad`` already off)."""
        train_loader = MolDataLoader(train_dataset, self.batch_size, collate_fn,
                                     shuffle=True, drop_last=True, seed=self.seed)
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0:
            raise ValueError(
                f"train set ({len(train_dataset)}) smaller than batch size {self.batch_size}")
        # the schedule runs in optimizer updates: with accumulation one
        # comes every accumulate_steps mini-steps
        num_updates = max(1, steps_per_epoch * self.max_epochs // self.accumulate_steps)
        programs = self._train_programs(
            model, stateful_loss or loss_fn, num_updates, fds_state, fds_bucket, frozen,
            use_infonce=use_infonce, use_ct=use_ct, use_weight=use_weight)
        fds_state = programs.fds_state
        eval_step = build_eval_step(model, loss_fn, activation_fn, self.alpha)

        use_fds = self.fds and fds_state is not None
        feed_on = self.feed_engaged(collate_fn, train_dataset, valid_dataset)
        val_device_data = None
        if feed_on:
            train_res, _ = self.dataset_to_device(train_dataset, collate_fn, slot="train")
            val_device_data = self.build_eval_device_data(model, valid_dataset, collate_fn,
                                                          loss_fn, activation_fn, slot="val")
            if use_fds:
                # the FDS pass sweeps the full batches in order (drop_last),
                # as the loader path does
                nf = len(train_dataset) // self.batch_size
                fds_idx = torch.arange(nf * self.batch_size, device=self.device).view(
                    nf, self.batch_size)
                fds_ns = torch.full((nf,), self.batch_size, dtype=torch.int64,
                                    device=self.device)
                fds_sweep = self.eval_sweep(model, loss_fn, activation_fn, with_pooled=True)
            logger.info("device_feed engaged: %d train + %d val molecules resident on %s",
                        len(train_dataset), len(valid_dataset), self.device)
        valid_loader = CachedLoader(MolDataLoader(valid_dataset, self.batch_size, collate_fn))
        fds_loader = None
        # K steps per dispatch.  The JAX package runs the whole epoch in one
        # dispatch unless steps_per_call is explicit: its scan compiles once
        # whatever its trip count.  A CUDA graph records every launch of
        # every step it holds (~4,250 a flagship step), so an epoch-sized
        # graph would cost capture time and host memory in proportion to
        # the epoch; the port's graphs hold steps_per_call steps.
        K = self.steps_per_call

        best_params = _snapshot(model)
        best_fds = _clone(fds_state)
        min_val_loss = float("inf")
        best_score = self.metrics.initial_best() if self.metrics else None
        use_metric_stop = isinstance(self.metrics_str, str) and self.metrics_str not in (
            "loss", "none", "")
        wait = 0
        start_epoch, global_step, resumed = self._resume_fit_state(dump_dir, fold, programs,
                                                                   train_loader)
        if self.data_group is not None:
            programs.broadcast_state()
        # per-epoch scalars; a resumed fit keeps the earlier run's rows
        history = _load_history(dump_dir, fold, start_epoch)
        if resumed is not None:
            best_params = {k: v.to(self.device)
                           for k, v in model_shard(model, resumed["best_params"]).items()}
            best_fds = ({k: v.to(self.device) for k, v in resumed["best_fds"].items()}
                        if fds_state is not None else None)
            es = resumed["early_stop"]
            min_val_loss, wait = float(es["min_val_loss"]), int(es["wait"])
            if use_metric_stop and not np.isnan(es["best_score"]):
                best_score = float(es["best_score"])
        saver = _AsyncSaver()
        # the trace is rank 0's (one writer)
        prof = DispatchProfiler(self.profile_dir if is_writer_process() else None,
                                self.profile_steps, name=f"fold{fold}")

        def dispatch(call, *args):
            """One train dispatch with the profiler's and debug_nans' hooks;
            returns its steps' metrics."""
            nonlocal global_step
            prof.begin(epoch == start_epoch)
            m = call(*args)
            prof.end(m)
            if self.debug_nans:
                check_finite(m, epoch, global_step)
            global_step += 1 if m.dim() == 1 else m.shape[0]
            return m

        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            programs.set_epoch(epoch)
            programs.metric_sums.zero_()
            if feed_on:
                idx_mat, _ = train_loader.epoch_index_matrix()
                nb = idx_mat.shape[0]
                k_feed = _snap_to_divisor(K, nb)
                if k_feed != min(K, nb) and epoch == start_epoch:
                    # a trailing partial block would be a second graph
                    logger.info("steps_per_call %d does not divide the %d-batch epoch; using "
                                "%d per dispatch (avoids a second graph for the trailing "
                                "block)", K, nb, k_feed)
                idx_dev = torch.from_numpy(idx_mat.astype(np.int64)).to(self.device)
                for k0 in range(0, nb, k_feed):
                    dispatch(programs.feed, train_res, idx_dev[k0:k0 + k_feed])
                count = nb
            else:
                count = self._train_epoch_from_host(programs, train_loader, K, dispatch)
            prof.epoch_summary(epoch)
            train_means = dict(zip(METRICS, (v / max(count, 1)
                                             for v in programs.metric_sums.tolist())))

            if use_fds and epoch >= fds_start_update:
                if feed_on:
                    _, _, all_feats, all_labels = fds_sweep(train_res, fds_idx, fds_ns)
                else:
                    if fds_loader is None:
                        fds_loader = CachedLoader(MolDataLoader(
                            train_dataset, self.batch_size, collate_fn, drop_last=True))
                    pooled, label_rows = [], []
                    for batch, labels in fds_loader:
                        feats, _ = self._split_batch(batch)
                        labels_d = self._labels(labels)
                        pooled.append(eval_step(feats, labels_d, labels.shape[0])[2])
                        label_rows.append(labels_d.float())
                    all_feats, all_labels = torch.cat(pooled), torch.cat(label_rows)
                programs.set_fds_state(fds_epoch_update(
                    fds_state, all_feats, all_labels, float(epoch), fds_bucket[0],
                    fds_bucket[1], fds_kernel, model.fds_cfg))
                logger.info("FDS stats updated for epoch %d", epoch)

            val_t0 = time.time()
            _, val_losses, metric_score = self.predict(
                model, valid_dataset, activation_fn, target_scaler, collate_fn,
                eval_step=eval_step, batches=valid_loader, device_data=val_device_data)
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
                best_fds = _clone(fds_state)
            else:
                wait += 1
            if self._save_epoch_state(saver, dump_dir, fold, epoch, global_step, programs,
                                      best_params, best_fds, min_val_loss, wait, best_score):
                logger.info("Stopping after epoch %d (stop_after_epoch=%d of %d); train state "
                            "saved: continue with resume=True", epoch + 1,
                            self.stop_after_epoch, self.max_epochs)
                break
            if wait >= self.patience:
                logger.warning("Early stopping at epoch: %d", epoch + 1)
                break

        prof.close()
        # an in-flight save lands before the fit returns; its failure is
        # logged, not raised, so the best checkpoint is still written
        try:
            saver.wait()
        except Exception:
            logger.exception("the periodic train-state save failed; still writing the best "
                             "checkpoint")
        # the whole model (a collective over the model group under tensor
        # parallelism: every rank takes part, rank 0 writes)
        save_checkpoint(dump_dir, fold, state_dict_to_flax_params(model_state(model, best_params)),
                        best_fds)
        if self.data_group is None:
            # the final predict reloads the artifact just written
            y_preds, _, _ = self.predict(model, valid_dataset, activation_fn, target_scaler,
                                         collate_fn, eval_step=eval_step, batches=valid_loader,
                                         load_from=(dump_dir, fold), device_data=val_device_data)
            return y_preds
        # only rank 0 wrote it: every rank evaluates the same best weights
        # in memory (the checkpoint holds exactly these values)
        with torch.no_grad():
            model.load_state_dict(best_params)
        y_preds, _, _ = self.predict(model, valid_dataset, activation_fn, target_scaler,
                                     collate_fn, eval_step=eval_step, batches=valid_loader,
                                     skip_metrics=True, device_data=val_device_data)
        barrier()
        return y_preds

    def _train_programs(self, model, loss_fn, num_updates: int, fds_state, fds_bucket,
                        frozen=frozenset(), **loss_kw) -> TrainPrograms:
        """The TrainPrograms of a fit: the last fit's, reset to a fresh
        start in place, when it would be built the same (cross-validation's
        next fold: its CUDA graphs replay again; the frozen set is part of
        what must match, since a graph records which gradients a step
        takes), else a new one with its optimizer over the model's
        parameters and a generator from the seed (this rank's stream under
        data parallelism)."""
        key = (id(model), id(loss_fn), num_updates, fds_state is None, tuple(fds_bucket),
               frozenset(frozen), tuple(sorted(loss_kw.items())))
        seed = self.seed if self.data_group is None else rank_seed(self.seed,
                                                                   self.data_group.rank)
        if self._last_programs is not None and self._last_programs[0] == key:
            programs = self._last_programs[2]
            programs.optimizer.reset()
            programs.generator.manual_seed(seed)
            if fds_state is not None:
                programs.set_fds_state(fds_state)
        else:
            # the old programs and their graphs go before new buffers come
            self._last_programs = None
            optimizer = FusedAdam(dict(model.named_parameters()), self.learning_rate,
                                  num_updates, self.warmup_ratio, self.max_norm, frozen=frozen,
                                  mu_dtype=self.mu_dtype, accumulate_steps=self.accumulate_steps,
                                  data_group=self.data_group, model_group=self.model_group)
            generator = torch.Generator(device=self.device).manual_seed(seed)
            programs = TrainPrograms(model, optimizer, loss_fn, self.task, generator,
                                     fds_state=fds_state, fds_bucket=fds_bucket,
                                     alpha=self.alpha, beta=self.beta, ct_w=self.ct_w, **loss_kw)
            self.programs_built += 1
            self._last_programs = (key, (model, loss_fn), programs)
        if hasattr(loss_fn, "reset"):
            loss_fn.reset()
        return programs

    def _train_epoch_from_host(self, programs: TrainPrograms, loader, K: int, dispatch) -> int:
        """One epoch of host-collated batches: K shape-equal batches stacked
        per dispatch, the rest one step at a time (a batch whose shapes
        differ from the pending ones flushes them as single steps, as under
        pad_mode='bucket'); ``dispatch(call, *args)`` runs each.  The
        batches come through data/pipeline.py's prefetch_to_device:
        collated in a background thread, put to the device two ahead (on
        the card from pinned memory on a side stream).  Under data
        parallelism a batch is collated whole and this rank keeps its rows
        of the features (the labels and weights whole).  Returns the number
        of steps."""
        count, pending, pend_sig = 0, [], None
        put = StreamPut(self.device)

        def stage(batch_labels):
            feats, weights = self._feature_arrays(batch_labels[0])
            if self.data_group is not None:
                feats = {k: self.data_group.local_rows(v) for k, v in feats.items()}
            return put((feats, self._label_array(batch_labels[1]), weights))

        def run_pending():
            for feats, labels, weights in pending:
                dispatch(programs.single, feats, labels, weights)

        for staged in prefetch_to_device(loader, stage):
            item = staged.take()
            feats, _, weights = item
            count += 1
            if K <= 1:
                dispatch(programs.single, *item)
                continue
            sig = tuple(sorted((k, tuple(v.shape)) for k, v in feats.items()))
            if pending and sig != pend_sig:
                run_pending()
                pending = []
            pend_sig = sig
            pending.append(item)
            if len(pending) == K:
                feats_k = {k: torch.stack([p[0][k] for p in pending]) for k in feats}
                weights_k = (None if weights is None
                             else torch.stack([p[2] for p in pending]))
                dispatch(programs.stacked, feats_k, torch.stack([p[1] for p in pending]),
                         weights_k)
                pending = []
        run_pending()
        return count
