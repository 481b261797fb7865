"""Dynamic request batching for MolServe (port of
mmdti_tpu/api/serve_batcher.py).

Coalesces concurrent predict requests into shared device batches and
pipelines the host stage (featurize + collate + launch) against the device
pull across consecutive batches.  Unlike the JAX package's copy, a rider's
in-flight slot is released exactly once: a batch that fails after some of
its riders were resolved retries only the others.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional


class OverloadedError(RuntimeError):
    """Raised by DynamicBatcher.submit when too many riders are in flight;
    the HTTP front maps it to 429 so clients can back off."""


class DynamicBatcher:
    """Coalesce concurrent predict requests into single device batches,
    pipelining host and device work across consecutive batches.

    A lone request waits at most ``window_ms`` for company; whatever arrived
    by then (capped at the largest batch bucket) rides one device batch: a
    few ms of added latency for many more molecules a launch when many
    clients hit the endpoint at once.

    Three threads:

    * the **dispatch loop** gathers riders, then runs the host stage
      (featurize + collate + launch, MolServe._dispatch_forward) and hands
      the in-flight device outputs to
    * the **completion thread**, which waits for the device pull
      (MolServe._finalize_forward) and distributes rows to riders;
    * the **retry worker**, which resolves the riders of a failed batch one
      request each, so that one rider's bad molecule fails only its own
      request and slow retries block neither pipeline thread.

    While batch k's pull waits on the device, the dispatch loop already
    featurizes batch k+1.  The bounded hand-off queue (``pipeline_depth``)
    back-pressures the dispatch loop.  ``max_pending`` bounds the riders in
    flight (queued, dispatched or parked for retry): past it, ``submit``
    raises OverloadedError.
    """

    _STOP = object()

    def __init__(self, serve, window_ms: float = 5.0,
                 max_batch: Optional[int] = None, pipeline_depth: int = 2,
                 max_pending: int = 1024):
        self.serve = serve
        self.window = float(window_ms) / 1e3
        self.max_batch = int(max_batch or serve.batch_buckets[-1])
        self.max_pending = int(max_pending)
        self._q: queue.Queue = queue.Queue()
        self._cq: queue.Queue = queue.Queue(maxsize=max(1, int(pipeline_depth)))
        self._rq: queue.Queue = queue.Queue()
        self.batches_run = 0
        self.requests_served = 0
        self._stats_lock = threading.Lock()
        self._inflight = 0   # admitted minus resolved riders: the shed gate
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mmdti-batcher-dispatch")
        self._cthread = threading.Thread(
            target=self._completion_loop, daemon=True, name="mmdti-batcher-complete")
        self._rthread = threading.Thread(
            target=self._retry_loop, daemon=True, name="mmdti-batcher-retry")
        self._thread.start()
        self._cthread.start()
        self._rthread.start()

    def stop(self):
        """Stop the pipeline and retry threads (idempotent)."""
        self._q.put(self._STOP)

    @property
    def _alive(self) -> bool:
        return (self._thread.is_alive() and self._cthread.is_alive()
                and self._rthread.is_alive())

    def submit(self, smiles: List[str]) -> Dict[str, Any]:
        """Blocking: returns this request's rows of the coalesced batch.

        Raises OverloadedError when ``max_pending`` riders are already in
        flight: each blocks an HTTP thread, so shedding here bounds memory
        and threads under a burst."""
        if not smiles:  # reject here: it must not fail a whole shared batch
            raise ValueError("empty SMILES request")
        with self._stats_lock:
            if self._inflight >= self.max_pending:
                raise OverloadedError(
                    f"{self._inflight} requests already in flight "
                    f"(max_pending={self.max_pending})"
                )
            self._inflight += 1
        done = threading.Event()
        holder: Dict[str, Any] = {}
        self._q.put((list(smiles), done, holder))
        # liveness guard: if a pipeline thread is gone (stop() or a fatal
        # error), fail loudly instead of blocking this client forever; the
        # slot is released here only if no thread resolved the rider first
        while not done.wait(timeout=1.0):
            if not self._alive and self._resolve(done):
                raise RuntimeError("DynamicBatcher is not running")
        if "error" in holder:
            raise holder["error"]
        return holder["out"]

    def _resolve(self, done) -> bool:
        """Resolve one rider: release its in-flight slot and wake it, once.
        Returns False (and does nothing) if it was already resolved."""
        with self._stats_lock:
            if done.is_set():
                return False
            self._inflight -= 1
            done.set()
        return True

    def _retry_each_alone(self, pending):
        # one rider's bad molecule (an unparseable SMILES raising in the
        # featurizer) must not fail the riders batched with it: each rider
        # still unresolved is retried alone
        for smi, done, holder in pending:
            if done.is_set():
                continue
            try:
                holder["out"] = self.serve.predict(list(smi))
            except Exception as e:
                holder["error"] = e
            self._resolve(done)

    def _distribute(self, pending, out):
        row = 0
        for smi, done, holder in pending:
            n = len(smi)
            holder["out"] = {
                "predict": out["predict"][row: row + n],
                "proba": None if out["proba"] is None else out["proba"][row: row + n],
                "target_cols": out["target_cols"],
                "valid": out["valid"][row: row + n],
            }
            row += n
            self._resolve(done)

    def _loop(self):
        """Dispatch loop: gather riders, run the host stage, hand off."""
        while True:
            first = self._q.get()
            if first is self._STOP:
                self._cq.put(self._STOP)  # completion drains, then exits
                self._rq.put(self._STOP)  # retry worker too
                return
            pending = [first]
            total = len(first[0])
            deadline = time.monotonic() + self.window
            while total < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._STOP:
                    self._q.put(self._STOP)  # stop after this batch
                    break
                pending.append(item)
                total += len(item[0])
            all_smiles = [s for smi, _, _ in pending for s in smi]
            t0 = time.perf_counter()
            try:
                chunks, feats = self.serve._dispatch_forward(all_smiles)
            except Exception:
                # host-stage failure (featurizer): the retry worker resolves
                # the batch per rider, through the completion thread so the
                # stats keep batch order
                self._cq.put((pending, None, None, t0))
                continue
            self._cq.put((pending, chunks, feats, t0))

    def _count_batch(self, n_riders: int):
        # counted BEFORE the riders wake: a client whose submit() returned
        # sees its batch in the stats
        with self._stats_lock:
            self.batches_run += 1
            self.requests_served += n_riders

    def _completion_loop(self):
        """Completion thread: pull device results, distribute to riders."""
        while True:
            item = self._cq.get()
            if item is self._STOP:
                return
            pending, chunks, feats, t0 = item
            self._count_batch(len(pending))
            if chunks is None:  # host-stage failure: per-rider isolation
                self._rq.put(pending)
                continue
            try:
                out = self.serve._finalize_forward(chunks, feats, t0)
                self._distribute(pending, out)
            except Exception:
                self._rq.put(pending)  # device-stage failure: the same

    def _retry_loop(self):
        """Retry worker: failed batches resolve per rider here."""
        while True:
            pending = self._rq.get()
            if pending is self._STOP:
                return
            try:
                self._retry_each_alone(pending)
            except Exception as e:  # never die mid-loop
                for _, done, holder in pending:
                    if not done.is_set():
                        holder["error"] = e
                        self._resolve(done)
