"""Dataset, loader and batch collation with static-shape padding.

Port of mmdti_tpu.data.batching: ``MolDataset``, ``MolDataLoader`` (the
same numpy shuffle, so both packages see the same batches for one seed; its
``epoch_index_matrix`` gives an epoch as row indices for the device-resident
feed, ``advance_epochs`` skips the epochs a resumed fit already ran),
``CachedLoader``, ``collate_dataset``, ``dataset_pad_lengths`` and
``BatchCollator``: pad src_tokens with the dictionary pad index,
src_distance with 0.0, src_edge_type with the pad index (``pair_feats=
"host"``) or src_coord with 0.0 in their place (``"device"``: the model
rebuilds the [B,N,N] arrays from the [B,N,3] coordinates,
ops/pair_feats.py), stack the MOF inputs (gas_id, gas_attr, pressure,
temperature) where the samples carry them, pad a docking complex's pocket
(pocket_src_tokens, pocket_src_coord, to ``pocket_pad``; the model builds
its pair arrays on the device) and its distance targets
(``docking_labels``), tokenize the SMILES strings
into input_ids/attention_mask, and return (features, labels).  'bucket'
mode pads to the same small set of static lengths as the JAX package
(utils/padding.py), so both packages see identical arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmdti_tpu_torch.utils.padding import (
    DEFAULT_ATOM_BUCKETS,
    DEFAULT_SMILES_BUCKETS,
    bucket_length,
    pad_1d_tokens,
    pad_2d,
    pad_coords,
)


class MolDataset:
    """(features, labels) pairs; features are the per-sample dicts produced by
    ConformerGen with 'smile' and 'weights' attached."""

    def __init__(self, features: Sequence[Dict[str, Any]], labels=None):
        self.features = list(features)
        if labels is None:
            labels = np.zeros((len(self.features), 1), dtype=np.float32)
        self.labels = np.asarray(labels)

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, idx: int):
        return self.features[idx], self.labels[idx]


class BatchCollator:
    def __init__(
        self,
        tokenizer,
        pad_idx: int,
        pad_mode: str = "dataset",
        atom_pad: Optional[int] = None,
        smiles_pad: Optional[int] = None,
        atom_buckets: Sequence[int] = DEFAULT_ATOM_BUCKETS,
        smiles_buckets: Sequence[int] = DEFAULT_SMILES_BUCKETS,
        pair_feats: str = "host",
        pocket_pad: Optional[int] = None,
    ):
        if pad_mode not in ("dataset", "fixed", "bucket", "ragged"):
            raise ValueError(
                f"unknown pad_mode {pad_mode!r}: expected 'dataset' (dataset-"
                "wide static shape), 'fixed' (config-wide static shape), "
                "'bucket', or 'ragged' (per-batch, CPU/debug)"
            )
        if pair_feats not in ("host", "device"):
            raise ValueError(
                f"unknown pair_feats {pair_feats!r}: 'host' ships the padded "
                "[B,N,N] distance/edge arrays; 'device' ships [B,N,3] coords "
                "and the model rebuilds them (ops/pair_feats.py)"
            )
        self.tokenizer = tokenizer
        self.pad_idx = pad_idx
        self.pad_mode = pad_mode
        self.pair_feats = pair_feats
        self.atom_pad = atom_pad
        self.smiles_pad = smiles_pad
        self.atom_buckets = tuple(atom_buckets)
        self.smiles_buckets = tuple(smiles_buckets)
        self.pocket_pad = pocket_pad

    def _atom_target(self, max_len: int) -> Optional[int]:
        # 'fixed' differs from 'dataset' only in WHO chose the pad targets
        # (config-wide constants vs dataset max, train/nnmodel.py) — both pad
        # every batch to one static shape here
        if self.pad_mode in ("dataset", "fixed") and self.atom_pad is not None:
            return self.atom_pad
        if self.pad_mode == "bucket":
            return bucket_length(max_len, self.atom_buckets)
        return None  # ragged per-batch (CPU/debug)

    def __call__(self, samples: List[Tuple[Dict[str, Any], Any]]):
        feats = [s[0] for s in samples]
        atom_len = max(len(f["src_tokens"]) for f in feats)
        pad_n = self._atom_target(atom_len)

        batch: Dict[str, np.ndarray] = {
            "src_tokens": pad_1d_tokens(
                [np.asarray(f["src_tokens"], dtype=np.int32) for f in feats],
                self.pad_idx, pad_to_length=pad_n,
            ),
        }
        if self.pair_feats == "device":
            batch["src_coord"] = pad_coords(
                [np.asarray(f["src_coord"], dtype=np.float32) for f in feats],
                0.0, pad_to_length=pad_n,
            )
        else:
            batch["src_distance"] = pad_2d(
                [np.asarray(f["src_distance"], dtype=np.float32) for f in feats],
                0.0, pad_to_length=pad_n,
            )
            batch["src_edge_type"] = pad_2d(
                [np.asarray(f["src_edge_type"], dtype=np.int32) for f in feats],
                self.pad_idx, pad_to_length=pad_n,
            )
        if "weights" in feats[0]:
            batch["weights"] = np.stack(
                [np.asarray(f["weights"], dtype=np.float32).reshape(-1) for f in feats]
            )
        # the MOF inputs (models/mof.py MOFModel)
        if "gas_id" in feats[0]:
            batch["gas_id"] = np.asarray([f["gas_id"] for f in feats], dtype=np.int32)
        for key in ("gas_attr", "temperature", "pressure"):
            if key in feats[0]:
                batch[key] = np.asarray([f[key] for f in feats], dtype=np.float32)

        # a docking complex's pocket (models/docking.py)
        if "pocket_src_tokens" in feats[0]:
            pocket_n = self.pocket_pad if self.pad_mode in ("dataset", "fixed") else None
            batch["pocket_src_tokens"] = pad_1d_tokens(
                [np.asarray(f["pocket_src_tokens"], dtype=np.int32) for f in feats],
                self.pad_idx, pad_to_length=pocket_n)
            batch["pocket_src_coord"] = pad_coords(
                [np.asarray(f["pocket_src_coord"], dtype=np.float32) for f in feats],
                0.0, pad_to_length=pocket_n)

        if "smile" in feats[0]:
            smiles = [f["smile"] for f in feats]
            if self.pad_mode in ("dataset", "fixed") and self.smiles_pad is not None:
                tok = self.tokenizer(smiles, pad_to=self.smiles_pad)
                if tok["input_ids"].shape[1] > self.smiles_pad:
                    # 'fixed' guarantees the width even for SMILES longer
                    # than the configured pad (tokenizers only widen)
                    tok = {k: v[:, : self.smiles_pad] for k, v in tok.items()}
            elif self.pad_mode == "bucket":
                probe = self.tokenizer(smiles)  # natural width
                width = probe["input_ids"].shape[1]
                target = bucket_length(width, self.smiles_buckets)
                tok = probe if width == target else self.tokenizer(smiles, pad_to=target)
            else:
                tok = self.tokenizer(smiles)
            batch["input_ids"] = tok["input_ids"].astype(np.int32)
            batch["attention_mask"] = tok["attention_mask"].astype(np.int32)

        labels = np.stack([np.asarray(s[1]) for s in samples])
        return batch, labels


def docking_labels(features: Sequence[Dict[str, Any]], atom_pad: int,
                   pocket_pad: int) -> np.ndarray:
    """[n, atom_pad, pocket_pad + atom_pad] float32: each complex's
    cross_target and holo_target (chem/pocket.py docking_targets) side by
    side, zero-padded, the labels of the docking loss (models/docking.py)."""
    out = np.zeros((len(features), atom_pad, pocket_pad + atom_pad), np.float32)
    for i, f in enumerate(features):
        cross, holo = np.asarray(f["cross_target"]), np.asarray(f["holo_target"])
        n, p = cross.shape
        if n > atom_pad or p > pocket_pad:
            raise ValueError(f"a complex of {n} ligand and {p} pocket tokens does not fit the "
                             f"pads {atom_pad} and {pocket_pad}")
        out[i, :n, :p] = cross
        out[i, :n, pocket_pad:pocket_pad + n] = holo
    return out


class MolDataLoader:
    """Shuffling, drop-last-capable batch iterator (numpy RNG)."""

    def __init__(
        self,
        dataset: MolDataset,
        batch_size: int,
        collate_fn: BatchCollator,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 42,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        """One epoch's sample order (advances the shuffle RNG)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def advance_epochs(self, n: int) -> None:
        """Draw and drop n epochs' shuffles: a resumed fit's fresh loader
        then orders its next epoch as the uninterrupted fit's loader did
        (both for __iter__ and epoch_index_matrix)."""
        for _ in range(max(int(n), 0)):
            self._epoch_order()

    def __iter__(self):
        idx = self._epoch_order()
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[i] for i in sel])

    def epoch_index_matrix(self):
        """One epoch's batches as row indices: ([num_batches, batch_size]
        int32, list of valid row counts).  The same RNG draw as __iter__, so
        the same batches; a trailing partial batch repeats its last index,
        as Trainer._pad_to_batch repeats its last row."""
        idx = self._epoch_order()
        bs = self.batch_size
        rows, valid_ns = [], []
        for b in range(len(self)):
            sel = idx[b * bs : (b + 1) * bs]
            valid_ns.append(len(sel))
            if len(sel) < bs:
                sel = np.concatenate([sel, np.repeat(sel[-1:], bs - len(sel))])
            rows.append(sel)
        return np.stack(rows).astype(np.int32), valid_ns


class CachedLoader:
    """A deterministic loader's batches, collated on the first pass and
    replayed after it (validation and the FDS pass see the same batches
    every epoch)."""

    def __init__(self, loader):
        self.loader = loader
        self._cache = None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self._cache is None:
            self._cache = list(self.loader)
        return iter(self._cache)


def collate_dataset(dataset: MolDataset, collate_fn: BatchCollator, chunk: int = 2048):
    """The whole dataset collated into [n, ...] arrays (features, labels),
    for the device-resident feed.  Needs a static pad_mode: every chunk then
    collates to the same widths."""
    if collate_fn.pad_mode not in ("dataset", "fixed"):
        raise ValueError(
            f"collate_dataset needs a static pad_mode ('dataset'/'fixed'); "
            f"got {collate_fn.pad_mode!r} whose widths vary per batch"
        )
    parts = [
        collate_fn([dataset[i] for i in range(s, min(s + chunk, len(dataset)))])
        for s in range(0, len(dataset), chunk)
    ]
    batch = {k: np.concatenate([p[0][k] for p in parts]) for k in parts[0][0]}
    labels = np.concatenate([p[1] for p in parts])
    return batch, labels


def dataset_pad_lengths(
    features: Sequence[Dict[str, Any]],
    tokenizer,
    pad_multiple: int = 16,
    extra_datasets: Sequence[Sequence[Dict[str, Any]]] = (),
) -> Tuple[int, int]:
    """Dataset-wide (atom, smiles) pad targets, rounded up to pad_multiple.

    Computed across train+val so both loops share one static shape.
    """
    def up(n):
        return int(-(-n // pad_multiple) * pad_multiple)

    all_feats = list(features)
    for ds in extra_datasets:
        all_feats.extend(ds)
    atom = max(len(f["src_tokens"]) for f in all_feats)
    if any("smile" not in f for f in all_feats):
        # MOF features carry no SMILES stream — there is nothing to tokenize
        # and the collator never consults smiles_pad without a 'smile' key
        return up(atom), 0
    # One batched tokenizer call per chunk (not one per sample), with
    # truncation on — so the pad target is what encode() will actually emit
    # (both tokenizers pad each chunk to its longest row, so the padded width
    # IS the chunk's max encoded length).
    smiles = [f["smile"] for f in all_feats]
    smi = 1
    for i in range(0, len(smiles), 4096):
        enc = tokenizer(smiles[i : i + 4096], truncation=True)
        smi = max(smi, int(np.asarray(enc["input_ids"]).shape[1]))
    return up(atom), up(smi)
