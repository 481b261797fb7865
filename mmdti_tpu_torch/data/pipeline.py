"""Async input pipeline (port of mmdti_tpu/data/pipeline.py): background
collation and a prefetched device feed.

A worker thread runs the loader (collation and tokenization, all numpy;
``AsyncLoader``), and ``device_prefetch`` keeps ``depth`` batches already
sent to the device ahead of the consumer.  On a CUDA device ``StreamPut``
is the put_fn: it copies a batch's arrays from pinned host memory with
``non_blocking=True`` on a side stream, so the copy of batch k+1 overlaps
the device's work on batch k, and the consumer's stream waits for that
batch's copies (``Staged.take``) before it uses them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

_SENTINEL = object()


class AsyncLoader:
    """Wraps an iterable loader; collation runs in a background thread."""

    def __init__(self, loader: Iterable, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone (a consumer
            that abandons the generator mid-epoch, an exception in the train
            loop, must not leave this thread blocked forever)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                _put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


def device_prefetch(iterator: Iterable, put_fn: Callable, depth: int = 2):
    """Keep ``depth`` batches put to the device ahead of the consumer.

    put_fn maps a host batch to what the consumer takes; when it only
    enqueues the copies (StreamPut), putting ahead overlaps them with the
    device's current step."""
    it = iter(iterator)
    buf = []
    try:
        for _ in range(depth):
            buf.append(put_fn(next(it)))
    except StopIteration:
        pass
    while buf:
        nxt = buf.pop(0)
        try:
            buf.append(put_fn(next(it)))
        except StopIteration:
            pass
        yield nxt


def prefetch_to_device(loader, put_fn, host_depth: int = 2, device_depth: int = 2):
    """Compose background collation with the prefetched device feed."""
    return device_prefetch(AsyncLoader(loader, depth=host_depth), put_fn, depth=device_depth)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class Staged:
    """A batch put to the device: ``take()`` returns it once the
    consumer's stream may read it."""

    def __init__(self, value, event: Optional["torch.cuda.Event"] = None):
        self.value = value
        self.event = event

    def take(self):
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)

            def mark(t):
                # the allocator must not hand the memory on before the
                # consumer's stream is done with it
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
                return t

            _tree_map(mark, self.value)
        return self.value


class StreamPut:
    """put_fn for device_prefetch: the numpy arrays of a (nested) batch
    become tensors on ``device`` (None entries stay None).  On a CUDA
    device each array is pinned and copied with ``non_blocking=True`` on a
    side stream, and an event recorded after the batch's copies (a
    ``wait_stream`` on that stream, taken at that point) orders them before
    the consumer's use; elsewhere the copy is a plain ``.to(device)``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _tensor(self, a):
        if a is None:
            return a
        t = torch.from_numpy(a)
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def __call__(self, batch: Any) -> Staged:
        if self.stream is None:
            return Staged(_tree_map(self._tensor, batch))
        with torch.cuda.stream(self.stream):
            value = _tree_map(self._tensor, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return Staged(value, event)
