"""MolServe: online inference with the model resident on one device (port
of mmdti_tpu/api/serve_api.py without mesh, HTTP front or fold ensembles).

SMILES are featurized on the host (ConformerGen + tokenizer, with a
per-SMILES LRU cache), collated onto the same static shape buckets as the
JAX package, run through the MMModel serving forward on the device, and
post-processed to MolPredict's output contract.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mmdti_tpu_torch.api.serve_model import load_resident_model, postprocess_predictions
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import load_tokenizer
from mmdti_tpu_torch.data.batching import BatchCollator

logger = logging.getLogger("mmdti_tpu_torch")

_FEATURE_KEYS = (
    "src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask",
)

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _feat_nbytes(feat: Dict[str, Any]) -> int:
    """Approximate host-RAM footprint of one cached featurization dict."""
    total = 0
    for v in feat.values():
        if isinstance(v, np.ndarray):
            total += v.nbytes
        elif isinstance(v, str):
            total += len(v)
    return total


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but CUDA is not available")
    return device


class MolServe:
    """Answer SMILES -> prediction requests with one resident model.

    Parameters
    ----------
    config:          the experiment config as a dict: ``task`` (default
                     regression), ``target_cols``, ``compute_dtype``
                     (default bfloat16), ``unimol_overrides`` /
                     ``chemberta_overrides`` / ``crossmodal_overrides``,
                     ``num_classes`` / ``multiclass_cnt``, and the
                     ConformerGen options (``seed``, ``max_atoms``,
                     ``remove_hs``).
    state_dict:      the model weights (models/convert.py names).
    device:          "cuda" (default) or "cpu"; "cuda" without CUDA raises.
    batch_buckets:   static batch sizes requests are padded onto; larger
                     requests are chunked at the largest bucket.
    feature_cache:   LRU entry bound for per-SMILES featurization (0 = off);
    feature_cache_bytes: host-RAM bound on the same cache.
    scaler:          optional target scaler (``inverse_transform``) for
                     regression outputs; threshold: classification cut.
    use_kernels:     False runs the plain-torch oracle path (for comparison).
    """

    def __init__(
        self,
        config: Mapping[str, Any],
        state_dict: Mapping[str, torch.Tensor],
        device: Union[str, torch.device] = "cuda",
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        num_workers: int = 0,
        feature_cache: int = 4096,
        feature_cache_bytes: int = 256 << 20,
        scaler=None,
        threshold: Union[float, np.ndarray] = 0.5,
        use_kernels: bool = True,
    ):
        self.device = resolve_device(device)
        cfg = dict(config)
        self.config = cfg
        self.task = cfg.get("task", "regression")
        self.target_cols = str(cfg.get("target_cols", "target")).split(",")
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not self.batch_buckets:
            raise ValueError("batch_buckets must be non-empty")

        self.tokenizer = load_tokenizer(cfg.get("chemberta_dir", "") or None)
        self.conformer = ConformerGen(**{**cfg, "num_workers": num_workers})
        self.dictionary = self.conformer.dictionary
        self.collator = BatchCollator(
            self.tokenizer, pad_idx=self.dictionary.pad(), pad_mode="bucket",
        )
        self.scaler = scaler
        self.threshold = threshold

        rm = load_resident_model(
            cfg, state_dict, self.task, self.dictionary, self.tokenizer,
            self.device, use_kernels=use_kernels,
        )
        self.model = rm.model
        self.output_dim = rm.output_dim
        self._forward = rm.forward
        self._shapes_seen: set = set()
        self._lock = threading.Lock()
        self._feat_cache: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._feat_cache_size = int(feature_cache)
        self._feat_cache_byte_cap = int(feature_cache_bytes)
        self._feat_cache_bytes = 0
        self.cache_hits = 0
        self._latencies: "deque[float]" = deque(maxlen=1024)
        self._lat_lock = threading.Lock()
        logger.info("MolServe ready: task=%s output_dim=%d device=%s kernels=%s",
                    self.task, self.output_dim, self.device, use_kernels)

    # ------------------------------------------------------------------
    def _featurize(self, smiles: List[str]) -> List[Dict[str, Any]]:
        cache = self._feat_cache
        if not self._feat_cache_size:
            feats = self.conformer.transform(smiles)
            for f, s in zip(feats, smiles):
                f["smile"] = s
            return feats
        # LRU: only the misses (first occurrence per unique string) run the
        # conformer ladder; cached dicts are shared read-only (the collator
        # copies into padded batch arrays and never mutates samples).
        resolved: Dict[str, Dict[str, Any]] = {}
        misses = []
        seen_miss = set()
        for s in smiles:
            if s in resolved or s in seen_miss:
                continue
            if s in cache:
                cache.move_to_end(s)
                resolved[s] = cache[s]
                self.cache_hits += 1
            else:
                seen_miss.add(s)
                misses.append(s)
        if misses:
            new_feats = self.conformer.transform(misses)
            for f, s in zip(new_feats, misses):
                f["smile"] = s
                resolved[s] = f
                cache[s] = f
                self._feat_cache_bytes += _feat_nbytes(f)
            while cache and (
                len(cache) > self._feat_cache_size
                or self._feat_cache_bytes > self._feat_cache_byte_cap
            ):
                _, evicted = cache.popitem(last=False)
                self._feat_cache_bytes -= _feat_nbytes(evicted)
        return [resolved[s] for s in smiles]

    def _place_feats(self, feats: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in feats.items()}

    def _device_feats(self, feats_chunk: List[Dict[str, Any]]):
        """Collate one chunk onto bucketed static shapes, on the device."""
        n = len(feats_chunk)
        bucket = next(b for b in self.batch_buckets if b >= n)
        padded = feats_chunk + [feats_chunk[-1]] * (bucket - n)
        zero = np.zeros(max(1, self.output_dim), dtype=np.float32)
        batch, _ = self.collator([(f, zero) for f in padded])
        self._shapes_seen.add(
            (bucket, batch["src_tokens"].shape[1], batch["input_ids"].shape[1])
        )
        return self._place_feats({k: batch[k] for k in _FEATURE_KEYS}), n

    def _run_batched(self, feats: List[Dict[str, Any]]) -> np.ndarray:
        max_chunk = self.batch_buckets[-1]
        outs = []
        for i in range(0, len(feats), max_chunk):
            dev, n = self._device_feats(feats[i: i + max_chunk])
            outs.append(self._forward(dev)[:n].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def predict(self, smiles: Union[str, Sequence[str]]) -> Dict[str, Any]:
        """SMILES (one or a list) -> {"predict", "proba", "target_cols",
        "valid"}.  Unembeddable SMILES fall back to zero coordinates and come
        back with valid=False; unparseable SMILES raise."""
        smi_list = [smiles] if isinstance(smiles, str) else list(smiles)
        if not smi_list:
            raise ValueError("empty SMILES request")
        t0 = time.perf_counter()
        with self._lock:
            feats = self._featurize(smi_list)
            raw = self._run_batched(feats)
        with self._lat_lock:
            self._latencies.append(time.perf_counter() - t0)
        out = postprocess_predictions(
            self.task, raw, self.scaler, self.threshold, self.config.get("multiclass_cnt"),
        )
        out["target_cols"] = self.target_cols
        out["valid"] = np.array(
            [not (np.asarray(f["src_coord"]) == 0.0).all() for f in feats]
        )
        return out

    def warmup_buckets(
        self,
        batch_sizes: Sequence[int] = (1,),
        atom_buckets: Optional[Sequence[int]] = None,
        smiles_buckets: Optional[Sequence[int]] = None,
    ):
        """Run the forward once on a grid of shape buckets (dummy inputs),
        so the first real request of each shape finds the kernels built and
        the allocator warm."""
        atom_buckets = tuple(atom_buckets or self.collator.atom_buckets[:3])
        smiles_buckets = tuple(smiles_buckets or self.collator.smiles_buckets[:3])
        pad = self.dictionary.pad()
        for b in batch_sizes:
            bucket = next(
                (x for x in self.batch_buckets if x >= int(b)), self.batch_buckets[-1]
            )
            for na in atom_buckets:
                for ns in smiles_buckets:
                    tok = np.full((bucket, na), pad, np.int32)
                    tok[:, 0] = self.dictionary.bos()  # >=1 valid atom: no 0-div pooling
                    feats = self._place_feats({
                        "src_tokens": tok,
                        "src_distance": np.zeros((bucket, na, na), np.float32),
                        "src_edge_type": np.full((bucket, na, na), pad, np.int32),
                        "input_ids": np.ones((bucket, ns), np.int32),
                        "attention_mask": np.ones((bucket, ns), np.int32),
                    })
                    self._forward(feats).cpu()
                    self._shapes_seen.add((bucket, na, ns))
        return self

    @property
    def compiled_shapes(self) -> int:
        return len(self._shapes_seen)

    def latency_stats(self) -> Dict[str, Any]:
        """Rolling p50/p95 over the last 1024 predict() calls (ms)."""
        with self._lat_lock:
            lats = list(self._latencies)
        if not lats:
            return {"count": 0, "p50_ms": None, "p95_ms": None}
        return {
            "count": len(lats),
            "p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "p95_ms": float(np.percentile(lats, 95)) * 1e3,
        }
