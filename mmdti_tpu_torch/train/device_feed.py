"""The device-resident input feed (port of mmdti_tpu/train/device_feed.py
on one device).

The fit collates its train and validation sets once and keeps them on the
trainer's device.  A train dispatch then takes a [K, B] index block and
gathers its batches' rows on the device (train/steps.py
TrainPrograms.feed), and validation, the FDS pass and bulk predict sweep the
resident arrays the same way (EvalSweep): no per-batch collation and no
per-batch host-to-device copy.  'auto' engages the feed when padding is
static and the resident bytes fit ``device_feed_bytes``.  One device needs
neither the JAX package's mesh nor its replication.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from mmdti_tpu_torch.data.batching import MolDataLoader, collate_dataset
from mmdti_tpu_torch.train.steps import EvalSweep, Resident

logger = logging.getLogger("mmdti_tpu_torch")

# the model inputs a batch may carry: the host pair arrays or the
# coordinates they are built from on the device (data/batching.py
# pair_feats), the SMILES stream, and the MOF inputs
FEATURE_KEYS = (
    "src_tokens", "src_distance", "src_edge_type", "src_coord",
    "input_ids", "attention_mask",
    "gas_id", "gas_attr", "pressure", "temperature",
    "pocket_src_tokens", "pocket_src_coord",
)


def normalize_device_feed(value):
    """Map every accepted device_feed spelling onto {'auto', True, False}.

    YAML and command-line round trips turn booleans into strings; a truthy
    'false' or 'off' must not behave as auto, so anything else raises."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v == "auto":
            return "auto"
        if v in ("true", "on", "1", "yes"):
            return True
        if v in ("false", "off", "0", "no", ""):
            return False
        raise ValueError(
            f"device_feed={value!r} not understood: expected 'auto', "
            "True/'true'/'on', or False/'false'/'off'"
        )
    if value is None:
        return False
    if isinstance(value, (bool, int)):
        return bool(value)
    raise ValueError(f"device_feed={value!r} not understood")


def row_bucket(n: int) -> int:
    """Resident row count: n rounded up to a multiple of 128 (at least
    128).  Datasets that differ by a few rows, as CV folds and protocol
    seeds' splits do, then get resident arrays of one shape; index blocks
    name real rows only, so the padding rows are never read."""
    return max(128, -(-n // 128) * 128)


def _tensors(resident: Resident):
    return [*(resident.feats[k] for k in sorted(resident.feats)), resident.labels,
            *(() if resident.weights is None else (resident.weights,))]


def _layout(resident: Resident):
    return (tuple(sorted(resident.feats)), resident.weights is None,
            [(tuple(t.shape), t.dtype) for t in _tensors(resident)])


class DeviceFeedMixin:
    """The feed's decisions and its host-to-device plumbing for the
    Trainer (which holds device, batch_size, device_feed,
    device_feed_bytes and the resident slots)."""

    def feed_engaged(self, collate_fn, *datasets) -> bool:
        """Does the resident feed run?  device_feed=False: never.  True:
        always, and static padding is required (bucket widths vary by
        batch, so they cannot live in one resident array).  'auto': when
        padding is static and the resident bytes, from a probe collation of
        8 rows, fit device_feed_bytes."""
        mode = self.device_feed
        if mode is False:
            return False
        static = getattr(collate_fn, "pad_mode", None) in ("dataset", "fixed")
        if not static:
            if mode is True:
                raise ValueError(
                    "device_feed=True requires static padding (pad_mode "
                    f"'dataset' or 'fixed'); got {getattr(collate_fn, 'pad_mode', None)!r}")
            return False
        if mode is True:
            return True
        total = 0
        for ds in datasets:
            if len(ds) == 0:
                continue
            # under static padding every collated row has the same bytes
            probe_n = min(len(ds), 8)
            batch, labels = collate_fn([ds[i] for i in range(probe_n)])
            per = sum(a.nbytes for k, a in batch.items()
                      if k in FEATURE_KEYS or k == "weights") + labels.nbytes
            total += int(per / probe_n * len(ds))
        if total > self.device_feed_bytes:
            logger.info("device_feed auto-disabled: ~%.0f MB resident inputs exceed the %.0f MB "
                        "cap (device_feed_bytes)", total / 1e6, self.device_feed_bytes / 1e6)
            return False
        return True

    def dataset_to_device(self, dataset, collate_fn, slot=None):
        """Collate ``dataset`` once and put it on the trainer's device, rows
        padded with zeros up to row_bucket.  Returns (Resident, the host
        label rows without padding).  With ``slot`` (a name: a fit's
        "train" or "val") the rows are copied into the Resident the last
        call with that slot returned when every array has its shape and
        dtype, so graphs recorded over it replay for the new rows (the next
        fold of a cross-validation); otherwise the new Resident takes the
        slot."""
        batch, labels = collate_dataset(dataset, collate_fn)
        rows = row_bucket(labels.shape[0])

        def pad_rows(x):
            x = np.asarray(x)
            if x.shape[0] == rows:
                return x
            return np.concatenate([x, np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)])

        feats, weights = self._split_batch({k: pad_rows(v) for k, v in batch.items()})
        resident = Resident(feats, self._labels(pad_rows(labels)), weights)
        if slot is None:
            return resident, labels
        held = self._slots.get(slot)
        if held is not None and _layout(held) == _layout(resident):
            with torch.no_grad():
                for dst, src in zip(_tensors(held), _tensors(resident)):
                    dst.copy_(src)
            return held, labels
        self._slots[slot] = resident
        return resident, labels

    def eval_sweep(self, model, loss_fn, activation_fn, with_pooled: bool = False) -> EvalSweep:
        """The sweep of this model and loss (one per Trainer, so its graphs
        serve every epoch and every fold's checkpoint)."""
        key = (id(model), id(loss_fn), id(activation_fn), with_pooled)
        hit = self._sweeps.get(key)
        if hit is None:
            hit = self._sweeps[key] = ((model, loss_fn, activation_fn),
                                       EvalSweep(model, loss_fn, activation_fn, self.alpha,
                                                 with_pooled))
        return hit[1]

    def build_eval_device_data(self, model, dataset, collate_fn, loss_fn, activation_fn,
                               eval_sweep=None, slot=None):
        """What predict(device_data=...) sweeps: the resident dataset (in
        ``slot``, as dataset_to_device keeps it), its batches in loader
        order as a [nb, B] index matrix (the last batch padded by repeating
        its last row), the valid rows per batch, the host labels and the
        sweep."""
        resident, labels_host = self.dataset_to_device(dataset, collate_fn, slot=slot)
        idx, valid_ns = MolDataLoader(dataset, self.batch_size, collate_fn).epoch_index_matrix()
        return {
            "resident": resident,
            "idx": torch.from_numpy(idx.astype(np.int64)).to(self.device),
            "valid_ns": valid_ns,
            "valid_ns_dev": torch.tensor(valid_ns, dtype=torch.int64, device=self.device),
            "labels_host": labels_host,
            "eval_sweep": eval_sweep or self.eval_sweep(model, loss_fn, activation_fn),
        }
