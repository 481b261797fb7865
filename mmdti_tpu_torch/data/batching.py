"""Dataset, loader and batch collation with static-shape padding.

Port of mmdti_tpu.data.batching: ``MolDataset``, ``MolDataLoader`` (the
same numpy shuffle, so both packages see the same batches for one seed),
``dataset_pad_lengths`` and ``BatchCollator`` with host pair features only:
pad src_tokens with the dictionary pad index, src_distance with 0.0,
src_edge_type with the pad index, tokenize the SMILES strings into
input_ids/attention_mask, and return (features, labels).  'bucket' mode pads
to the same small set of static lengths as the JAX package
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
    ):
        if pad_mode not in ("dataset", "fixed", "bucket", "ragged"):
            raise ValueError(
                f"unknown pad_mode {pad_mode!r}: expected 'dataset' (dataset-"
                "wide static shape), 'fixed' (config-wide static shape), "
                "'bucket', or 'ragged' (per-batch, CPU/debug)"
            )
        self.tokenizer = tokenizer
        self.pad_idx = pad_idx
        self.pad_mode = pad_mode
        self.atom_pad = atom_pad
        self.smiles_pad = smiles_pad
        self.atom_buckets = tuple(atom_buckets)
        self.smiles_buckets = tuple(smiles_buckets)

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

    def __iter__(self):
        idx = self._epoch_order()
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[i] for i in sel])


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
