"""MolServe: online inference over a trained experiment dir (port of
mmdti_tpu/api/serve_api.py on one device).

- The experiment dir that ``MolTrain.fit`` writes (config.yaml,
  ``model_{fold}.ckpt``, target_scaler.ss, threshold.dat) loads once; the
  weights stay resident on the device between requests, one model per
  served fold (api/serve_model.py).
- Raw SMILES are featurized (ConformerGen + tokenizer, with a per-SMILES
  LRU cache) and padded onto static (batch, atom, SMILES) shape buckets.
  ``coord_provider`` 'auto' refines a cold request's conformers on the
  card (chem/device_conformer.py; molecules under
  ``device_refine_min_atoms`` atoms on the host), under the lock, on the
  refinement stream (ops/device_refine.py ``refine_stream``), so it does
  not wait for the forward of the request before; a refinement graph
  records holding the pull gate, as the forward's do.  With 'auto' a
  cold request of a few large molecules is slower than on the host (a
  lone group replays about 9,900 small kernels); ``coord_provider: host``
  in the config trades the training-time provider for that latency.
  In device pair mode (``device_pair_feats`` 'auto' on the card) a request
  ships [B,N,3] coordinates and the forward builds the [B,N,N] distances
  and edge types from them (ops/pair_feats.py); in host mode the host
  builds and ships those arrays.
- On the card each bucket's forward is recorded once as a CUDA graph
  (train/steps.py ``capture_graph``) with static input buffers, at the
  bucket's first request or in ``warmup_buckets``, and replayed for every
  later request of that bucket: one graph launch instead of about 1,220
  kernel launches a forward.  All of a server's graphs record into one
  memory pool, so the graph cache holds about one forward's working set
  however many buckets it has seen.  On the CPU the forward runs eagerly.
- Post-processing (inverse target scaling, threshold binarization,
  multiclass argmax) follows MolPredict's output contract.
- ``make_server`` / ``serve`` put the stdlib HTTP front (api/serve_http.py)
  and the dynamic batcher (api/serve_batcher.py) in front of it.
- ``mesh_shape=(d, m)`` serves over d replicas of m tensor-parallel
  shards each in this one process, as the JAX package serves over a mesh:
  the mesh's d x m devices are the first cards, row-major (on the CPU,
  the CPU repeated, as the JAX package's virtual devices); replica i is
  devices[i*m:(i+1)*m].  With m = 1 each replica holds the resident model
  (every served fold); with m > 1 each holds one fold's model in m shards
  (api/serve_model.py; a fold ensemble raises) whose forward runs them in
  lockstep with the reductions between them (parallel/mesh.py
  ReplicaShards).  The batch buckets round up to multiples of d, each
  chunk's rows split evenly over the replicas (one CUDA graph per replica
  and bucket, in a pool per replica) and their outputs concatenate in
  order.  A replica whose shards share one card is one CUDA graph per
  bucket, shards and reductions included; a server whose replicas span
  several cards runs eagerly (one graph records one device).  More
  devices than cards raises.

MolServe serves molecules, as the JAX package's does.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mmdti_tpu_torch.api.predict_api import load_threshold
from mmdti_tpu_torch.api.serve_model import (
    load_resident_model,
    postprocess_predictions,
    resident_model,
)
from mmdti_tpu_torch.api.train_api import THRESHOLD_FILE
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import load_tokenizer
from mmdti_tpu_torch.configs.config import load_yaml
from mmdti_tpu_torch.data.batching import BatchCollator
from mmdti_tpu_torch.data.scaler import TargetScaler
from mmdti_tpu_torch.ops.hopper_ln import ln_kernels_on
from mmdti_tpu_torch.ops.pair_feats import resolve_pair_feats_mode
from mmdti_tpu_torch.parallel.mesh import make_mesh
from mmdti_tpu_torch.train.steps import _Graph, capture_graph
from mmdti_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mmdti_tpu_torch")

_FEATURE_KEYS = (
    "src_tokens", "src_distance", "src_edge_type", "src_coord", "input_ids", "attention_mask",
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


def _tree(fn: Callable, out):
    """fn over a tensor or over each tensor of a tuple."""
    return tuple(fn(x) for x in out) if isinstance(out, tuple) else fn(out)


class _Replicas(list):
    """The outputs of one launch on a mesh: each replica's, in row order."""


def _to_host(out):
    """A launch's output as host arrays (a meshed launch's concatenated)."""
    if not isinstance(out, _Replicas):
        return _tree(lambda x: x.float().cpu().numpy(), out)
    parts = [_to_host(o) for o in out]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p, axis=0) for p in zip(*parts))
    return np.concatenate(parts, axis=0)


class MolServe:
    """Load a trained experiment dir once; answer SMILES -> prediction
    requests.

    Parameters
    ----------
    load_model:      experiment dir written by MolTrain.fit (config.yaml,
                     model_{fold}.ckpt, target_scaler.ss, threshold.dat).
    use_kernels:     True runs the hand-written kernels (their plain
                     versions on CPU tensors); False the plain path.
    batch_buckets:   static batch sizes requests are padded onto; larger
                     requests are chunked at the largest bucket.
    num_workers:     host featurization threads (0 = inline).
    feature_cache:   LRU entry bound for per-SMILES featurization (0 = off).
    feature_cache_bytes: host-RAM bound on the same cache.
    device_pair_feats: 'auto' (device on the card, host on the CPU) |
                     'device'/True: requests ship [B,N,3] coordinates and
                     the forward builds the pair arrays | 'host'/False: the
                     host builds and ships the dense [B,N,N] arrays.
    serve_folds:     1 (default): fold 0.  K or 'all': the first K (or all)
                     fold checkpoints of a CV experiment as an ensemble;
                     the forward is the mean of their activated outputs,
                     K models resident and K forwards a request.
    mesh_shape:      None, or (d, m): d replicas of m tensor-parallel shards,
                     one shard a card (on the CPU, all on the CPU), the
                     batch buckets rounded up to multiples of d and each
                     chunk split evenly over the replicas.  d x m above the
                     visible cards raises; m > 1 serves one fold and runs
                     eagerly where a replica spans several cards.
    device:          "cuda" (default) or "cpu"; "cuda" without CUDA raises.
                     On the card each shape bucket's forward is a CUDA
                     graph; a capture that fails raises.
    """

    def __init__(
        self,
        load_model: str,
        use_kernels: bool = True,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        num_workers: int = 0,
        feature_cache: int = 4096,
        feature_cache_bytes: int = 256 << 20,
        device_pair_feats: Union[str, bool] = "auto",
        serve_folds: Union[str, int] = 1,
        mesh_shape: Optional[Sequence[int]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if not load_model or not os.path.isdir(load_model):
            raise ValueError(f"load_model must be an experiment dir, got {load_model!r}")
        self.load_model = load_model
        cfg = dict(load_yaml(os.path.join(load_model, "config.yaml")))
        task = cfg.get("task", "regression")
        scaler = (
            TargetScaler(cfg.get("target_normalize", "none"), task, load_model)
            if cfg.get("use_scaler", True) else None
        )
        threshold: Union[float, np.ndarray] = 0.5
        thr_path = os.path.join(load_model, THRESHOLD_FILE)
        if os.path.exists(thr_path):
            threshold = load_threshold(thr_path)
        self._setup(
            cfg, lambda dev, d, tok: load_resident_model(
                load_model, cfg, task, d, tok, dev, use_kernels, serve_folds),
            device, batch_buckets, num_workers, feature_cache, feature_cache_bytes,
            scaler, threshold, device_pair_feats, mesh_shape,
        )

    @classmethod
    def from_state_dict(
        cls,
        config: Mapping[str, Any],
        state_dict: Mapping[str, torch.Tensor],
        device: Union[str, torch.device] = "cuda",
        use_kernels: bool = True,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        num_workers: int = 0,
        feature_cache: int = 4096,
        feature_cache_bytes: int = 256 << 20,
        scaler=None,
        threshold: Union[float, np.ndarray] = 0.5,
        device_pair_feats: Union[str, bool] = "auto",
    ) -> "MolServe":
        """A server over weights held in memory: ``config`` as config.yaml
        holds it (``task``, ``target_cols``, ``compute_dtype``, the
        ``*_overrides``, ``num_classes`` / ``multiclass_cnt`` and the
        ConformerGen options), ``state_dict`` under models/convert.py's
        names, one fold."""
        self = cls.__new__(cls)
        self.load_model = None
        cfg = dict(config)
        task = cfg.get("task", "regression")
        self._setup(
            cfg, lambda dev, d, tok: resident_model(cfg, [state_dict], task, d, tok, dev,
                                                    use_kernels),
            device, batch_buckets, num_workers, feature_cache, feature_cache_bytes,
            scaler, threshold, device_pair_feats,
        )
        return self

    def _setup(self, cfg, load, device, batch_buckets, num_workers, feature_cache,
               feature_cache_bytes, scaler, threshold, device_pair_feats, mesh_shape=None):
        self.device = resolve_device(device)
        self.mesh = None
        # each replica's devices: one, or its m shards'
        shards = [[self.device]]
        if mesh_shape is not None:
            d, m = (int(x) for x in mesh_shape)
            cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                     if self.device.type == "cuda" else [self.device] * (d * m))
            self.mesh = make_mesh((d, m), cards)
            devs = list(self.mesh.devices)
            shards = [devs[i * m:(i + 1) * m] for i in range(d)]
            self.device = devs[0]
        replicas = [r[0] for r in shards]
        self.replica_devices = replicas
        self.pair_mode = resolve_pair_feats_mode(device_pair_feats, self.device)
        self.config = cfg
        self.task = cfg.get("task", "regression")
        self.target_cols = str(cfg.get("target_cols", "target")).split(",")
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not self.batch_buckets:
            raise ValueError("batch_buckets must be non-empty")
        dp = len(replicas)
        if dp > 1:
            # each replica takes an equal share of a bucket's rows: round
            # up, so every request still fits one bucket
            self.batch_buckets = tuple(sorted({max(dp, -(-b // dp) * dp)
                                               for b in self.batch_buckets}))

        # _lock serializes the host stage and every launch (eager, capture,
        # replay); _pull_gate keeps device -> host pulls, which run outside
        # _lock, from overlapping a capture (_record, and the conformer
        # refinement's graphs)
        self._lock = threading.Lock()
        self._pull_gate = threading.Lock()
        self.tokenizer = load_tokenizer(cfg.get("chemberta_dir", "") or None)
        self.conformer = ConformerGen(**{
            **cfg, "num_workers": num_workers, "device": self.device,
            "capture_gate": self._pull_gate, "pair_feats": self.pair_mode == "host"})
        # ConformerGen resolves the atom dictionary as NNModel does
        self.dictionary = self.conformer.dictionary
        self.collator = BatchCollator(
            self.tokenizer, pad_idx=self.dictionary.pad(), pad_mode="bucket",
            pair_feats=self.pair_mode,
        )
        self.scaler = scaler
        self.threshold = threshold

        rms = [load(devs if len(devs) > 1 else devs[0], self.dictionary, self.tokenizer)
               for devs in shards]
        rm = rms[0]
        self.model = rm.model
        self.output_dim = rm.output_dim
        self.serve_folds = rm.serve_folds
        self._replica_fns = [{"forward": r.forward, "embed": r.embed} for r in rms]
        # a graph records one device: a replica over several cards runs eagerly
        self.use_graphs = self.device.type == "cuda" and all(len(set(r)) == 1 for r in shards)
        self.graphs: Dict[tuple, _Graph] = {}
        # one pool for every graph of a replica: its captures and replays
        # are serialized under _lock, each graph's inputs live outside the
        # pool and its outputs are held (self.graphs) and cloned before
        # _lock is released
        self._pools = [torch.cuda.graph_pool_handle() if self.use_graphs else None
                       for _ in replicas]
        self._pool = self._pools[0]
        self._shapes_seen: set = set()
        self._feat_cache: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._feat_cache_size = int(feature_cache)
        self._feat_cache_byte_cap = int(feature_cache_bytes)
        self._feat_cache_bytes = 0
        self.cache_hits = 0
        self._latencies: "deque[float]" = deque(maxlen=1024)
        self._lat_lock = threading.Lock()
        logger.info("MolServe ready: task=%s output_dim=%d folds=%d device=%s replicas=%d "
                    "graphs=%s pair features=%s", self.task, self.output_dim, self.serve_folds,
                    self.device, dp, self.use_graphs, self.pair_mode)

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

    def _collate(self, feats_chunk: List[Dict[str, Any]]):
        """One chunk padded onto its (batch, atom, SMILES) bucket: the
        model's input arrays and the number of real rows."""
        n = len(feats_chunk)
        bucket = next(b for b in self.batch_buckets if b >= n)
        padded = feats_chunk + [feats_chunk[-1]] * (bucket - n)
        zero = np.zeros(max(1, self.output_dim), dtype=np.float32)
        batch, _ = self.collator([(f, zero) for f in padded])
        return {k: np.ascontiguousarray(batch[k]) for k in _FEATURE_KEYS if k in batch}, n

    def _place_feats(self, arrays: Dict[str, np.ndarray],
                     device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device or self.device) for k, v in arrays.items()}

    # --- one launch of the forward or the embed -------------------------
    @staticmethod
    def _graph_key(kind: str, arrays: Dict[str, np.ndarray], device: torch.device) -> tuple:
        """What a graph on ``device`` freezes beyond the server's own
        settings: the shape bucket and the LayerNorm kernels' setting in
        force there."""
        return (kind, arrays["src_tokens"].shape[0], arrays["src_tokens"].shape[1],
                arrays["input_ids"].shape[1], ln_kernels_on(device))

    def _record(self, kind: str, arrays: Dict[str, np.ndarray], replica: int = 0) -> _Graph:
        """Record ``kind``'s forward at this bucket into a CUDA graph in
        the replica's pool.  The pull gate is held throughout: a device ->
        host copy synchronizes, which a capture in CUDA's global mode
        forbids in every thread."""
        fn = self._replica_fns[replica][kind]
        dev = self.replica_devices[replica]
        inputs = self._place_feats(arrays, dev)
        with self._pull_gate, torch.no_grad(), torch.cuda.device(dev):
            graph, out = capture_graph(lambda: fn(inputs), pool=self._pools[replica])
        return _Graph(graph, inputs, out)

    def _launch(self, kind: str, arrays: Dict[str, np.ndarray]):
        """Run ``kind`` ("forward" or "embed") on one collated chunk; the
        caller holds _lock.  Returns device tensors the next launch does not
        overwrite: a replay's static outputs are cloned on the stream
        before the lock is released.  On a mesh each replica takes its
        equal share of the rows, and the launch returns their outputs
        (_Replicas) in row order."""
        self._shapes_seen.add((arrays["src_tokens"].shape[0], arrays["src_tokens"].shape[1],
                               arrays["input_ids"].shape[1]))
        dp = len(self.replica_devices)
        if dp == 1:
            return self._launch_on(0, kind, arrays)
        per = arrays["src_tokens"].shape[0] // dp
        return _Replicas(self._launch_on(r, kind, {k: v[r * per:(r + 1) * per]
                                                   for k, v in arrays.items()})
                         for r in range(dp))

    def _launch_on(self, replica: int, kind: str, arrays: Dict[str, np.ndarray]):
        if not self.use_graphs:
            with torch.no_grad():
                return self._replica_fns[replica][kind](
                    self._place_feats(arrays, self.replica_devices[replica]))
        key = self._graph_key(kind, arrays, self.replica_devices[replica])
        if replica:
            key = (*key, replica)
        prog = self.graphs.get(key)
        if prog is None:
            prog = self.graphs[key] = self._record(kind, arrays, replica)
        with torch.no_grad(), torch.cuda.device(self.replica_devices[replica]):
            for k, t in prog.inputs.items():
                t.copy_(torch.from_numpy(arrays[k]))
            prog.graph.replay()
            return _tree(torch.clone, prog.out)

    # --- staged execution: dispatch (host work + launches) / pull ---------
    # The dispatch stage returns device tensors still being computed; the
    # pull waits for them outside the lock, so a pipeline (DynamicBatcher's
    # completion thread) featurizes request k+1 while the device runs k.
    def _dispatch_batched(self, feats: List[Dict[str, Any]], kind: str):
        """Collate chunks (at most the largest batch bucket each) and
        launch ``kind`` on each: [(device out, n valid), ...] in flight."""
        max_chunk = self.batch_buckets[-1]
        chunks = []
        for i in range(0, len(feats), max_chunk):
            arrays, n = self._collate(feats[i: i + max_chunk])
            chunks.append((self._launch(kind, arrays), n))
        return chunks

    def _pull_batched(self, chunks):
        """Wait for the dispatched chunks; concatenate their valid rows."""
        with self._pull_gate:
            outs = [_tree(lambda x: x[:n], _to_host(out)) for out, n in chunks]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
        return np.concatenate(outs, axis=0)

    def _dispatch_forward(self, smiles: List[str]):
        """Featurize, collate and launch under the lock; returns (chunks,
        feats)."""
        with self._lock:
            feats = self._featurize(smiles)
            chunks = self._dispatch_batched(feats, "forward")
        return chunks, feats

    def _finalize_forward(self, chunks, feats: List[Dict[str, Any]],
                          t0: float) -> Dict[str, Any]:
        """Pull the dispatched chunks, postprocess, record the latency.
        Runs outside the lock."""
        raw = self._pull_batched(chunks)
        with self._lat_lock:
            self._latencies.append(time.perf_counter() - t0)
        out = postprocess_predictions(
            self.task, raw, self.scaler, self.threshold, self.config.get("multiclass_cnt"),
        )
        out["target_cols"] = self.target_cols
        # a molecule that fell through the conformer ladder to zero
        # coordinates still gets a prediction but is flagged
        out["valid"] = np.array(
            [not (np.asarray(f["src_coord"]) == 0.0).all() for f in feats]
        )
        return out

    # ------------------------------------------------------------------
    def predict(self, smiles: Union[str, Sequence[str]]) -> Dict[str, Any]:
        """SMILES (one or a list) -> {"predict", "proba", "target_cols",
        "valid"}.  Unembeddable SMILES fall back to zero coordinates and come
        back with valid=False; unparseable SMILES raise."""
        smi_list = [smiles] if isinstance(smiles, str) else list(smiles)
        if not smi_list:
            raise ValueError("empty SMILES request")
        t0 = time.perf_counter()
        chunks, feats = self._dispatch_forward(smi_list)
        return self._finalize_forward(chunks, feats, t0)

    def embed(self, smiles: Union[str, Sequence[str]]):
        """SMILES -> (cls_repr, pooled) feature matrices of fold 0 (the
        serving analog of MolPredict(extract_feature=True))."""
        smi_list = [smiles] if isinstance(smiles, str) else list(smiles)
        with self._lock:
            feats = self._featurize(smi_list)
            return self._pull_batched(self._dispatch_batched(feats, "embed"))

    def warmup(self, batch_sizes: Sequence[int] = (1,), smiles: str = "CCO"):
        """Answer one request of each batch size, so that its bucket's
        graph is recorded before the first real request."""
        for b in batch_sizes:
            self.predict([smiles] * int(b))
        return self

    def warmup_buckets(
        self,
        batch_sizes: Sequence[int] = (1,),
        atom_buckets: Optional[Sequence[int]] = None,
        smiles_buckets: Optional[Sequence[int]] = None,
    ):
        """Run the forward once on a grid of shape buckets from dummy
        inputs (on the card: record each bucket's graph), so that no real
        request pays for it.  Batch sizes beyond the largest bucket clamp
        to it."""
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
                    arrays = {
                        "src_tokens": tok,
                        "input_ids": np.ones((bucket, ns), np.int32),
                        "attention_mask": np.ones((bucket, ns), np.int32),
                    }
                    # the inputs a request of this pair mode ships
                    if self.pair_mode == "device":
                        arrays["src_coord"] = np.zeros((bucket, na, 3), np.float32)
                    else:
                        arrays["src_distance"] = np.zeros((bucket, na, na), np.float32)
                        arrays["src_edge_type"] = np.full((bucket, na, na), pad, np.int32)
                    with self._lock:
                        out = self._launch("forward", arrays)
                    self._pull_batched([(out, bucket)])
        return self

    @property
    def compiled_shapes(self) -> int:
        """Recorded graphs on the card; shape buckets seen elsewhere."""
        return len(self.graphs) if self.use_graphs else len(self._shapes_seen)

    def latency_stats(self) -> Dict[str, Any]:
        """Rolling p50/p95 over the last 1024 predict() calls (ms)."""
        with self._lat_lock:
            lats = list(self._latencies)
        if not lats:
            return {"count": 0, "p50_ms": None, "p95_ms": None}
        return {
            "count": len(lats),
            "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 2),
            "p95_ms": round(float(np.percentile(lats, 95)) * 1e3, 2),
        }

    # ------------------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1", port: int = 8000,
                    dynamic_batch_window_ms: float = 0.0):
        """Build (without starting) the HTTP front (api/serve_http.py):
        POST /predict, POST /embed, GET /health.  dynamic_batch_window_ms
        > 0 coalesces concurrent /predict requests into shared batches
        (DynamicBatcher, as ``server.batcher``)."""
        from mmdti_tpu_torch.api.serve_http import make_server

        return make_server(self, host, port, dynamic_batch_window_ms)

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              dynamic_batch_window_ms: float = 0.0):
        """Blocking HTTP serving loop."""
        server = self.make_server(host, port, dynamic_batch_window_ms)
        logger.info("MolServe listening on http://%s:%d", host, server.server_port)
        try:
            server.serve_forever()
        finally:
            server.server_close()
