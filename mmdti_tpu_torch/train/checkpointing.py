"""Best-weights checkpoint, train state and resume, and the per-epoch
history (port of mmdti_tpu/train/checkpointing.py on one device).

``model_{fold}.ckpt`` keeps the JAX package's flax-msgpack format:
``{"params": <flax parameter tree>, "fds": {<FDS state>}}``, each array as
msgpack extension type 1 holding the msgpack triple (shape, dtype name,
C-order bytes), as ``flax.serialization.msgpack_serialize`` writes it.  The
small codec below writes and reads exactly that (maps, arrays, str, bin,
int, float, bool, nil, ext) without the msgpack package, so either package
restores the other's checkpoint.  The parameter names are the flax paths
that models/convert.py maps onto the port's state dict.
``history_{fold}.json`` is the per-epoch scalar log.

``train_state_{fold}.ckpt`` is the whole state a fit carries from epoch to
epoch, in the same codec: the optimizer's flat parameter, moment and
count buffers (and the accumulation buffers), the FDS state, the task
loss's state (GHM's bins and flag), the dropout generator's state, the
epoch and global step, the best weights and FDS state so far, and the
early-stop triple.  ``CheckpointResumeMixin`` writes it every
``checkpoint_interval`` epochs and at ``stop_after_epoch``, and
``resume=True`` copies it back into the same tensors (a CUDA graph holds
their addresses) and realigns the loader's shuffle, so the resumed fit
continues the uninterrupted trajectory bit for bit.  The file is the
port's own: the JAX package's train state holds optax trees that map onto
no buffer here, and either package refuses the other's.

The single-writer rule of data parallelism (parallel/mesh.py): every rank
runs the same fit against one experiment dir and only rank 0 writes the
checkpoint, the history and the train state (a data-parallel train state
holds every data rank's generator state); a resume reads rank 0's files
on every rank.  Under tensor parallelism both files hold the whole model,
gathered over the model group (``model_{fold}.ckpt`` is what a fit
without one writes, so MolPredict, MolServe at any mesh and the JAX
package read it), and a resume cuts the train state to each rank's shard.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmdti_tpu_torch.parallel.mesh import is_writer_process, model_state

logger = logging.getLogger("mmdti_tpu_torch")

EXT_NDARRAY = 1     # flax _MsgpackExtType.ndarray
EXT_NPSCALAR = 3    # flax _MsgpackExtType.npscalar


# ---- msgpack ----------------------------------------------------------------

def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2 ** 8:
            out += bytes((0xD9, n))
        elif n < 2 ** 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 2 ** 8:
            out += bytes((0xC4, n))
        elif n < 2 ** 16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += obj
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 2 ** 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k in sorted(obj):     # flax flattens the tree, which sorts the keys
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 2 ** 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError("object arrays cannot be checkpointed")
        body = msgpack_serialize((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))
        _pack_ext(EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR, body, out)
    else:
        raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if n < lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                               (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if n >= -lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 2 ** 8:
        out += bytes((0xC7, n))
    elif n < 2 ** 16:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out.append(code)
    out += data


def msgpack_serialize(tree) -> bytes:
    """A tree of dicts, lists and scalars with numpy leaves -> the bytes
    flax.serialization.msgpack_serialize writes for it."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool, bfloat16_bits: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw
        self.bfloat16_bits = bfloat16_bits

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype_name, buffer = unpackb(data, raw=True)
            name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
            if name == "bfloat16":
                if not self.bfloat16_bits:
                    raise ValueError("bfloat16 arrays are not read by this codec")
                name = "uint16"      # the raw bits
            arr = np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C").copy()
            return arr if code == EXT_NDARRAY else arr[()]
        raise ValueError(f"unknown msgpack extension type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self.str_(n)
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map_(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False, bfloat16_bits: bool = False):
    """The object msgpack ``data`` holds; bfloat16 arrays raise, or come
    back as their uint16 bits with ``bfloat16_bits``."""
    r = _Reader(data, raw, bfloat16_bits)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def msgpack_restore(blob: bytes):
    tree = unpackb(blob)
    if _has_chunks(tree):
        raise ValueError("chunked arrays (over 1 GiB) are not read by this codec")
    return tree


def _has_chunks(tree) -> bool:
    return isinstance(tree, dict) and (
        "__msgpack_chunked_array__" in tree or any(_has_chunks(v) for v in tree.values()))


# ---- artifacts ----------------------------------------------------------------

def checkpoint_path(dump_dir: str, fold: int) -> str:
    return os.path.join(dump_dir, f"model_{fold}.ckpt")


def save_checkpoint(dump_dir: str, fold: int, params: Dict[str, Any],
                    fds_state: Optional[Dict[str, Any]] = None) -> None:
    """Write the best-weights checkpoint; ``params`` is the flax parameter
    tree of numpy arrays (models/convert.py::state_dict_to_flax_params),
    ``fds_state`` a dict of arrays or tensors, or None.  Rank 0 writes it
    (the single-writer rule); another rank does nothing."""
    if not is_writer_process():
        return
    os.makedirs(dump_dir, exist_ok=True)
    fds = {} if fds_state is None else {
        k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in fds_state.items()}
    blob = msgpack_serialize({"params": params, "fds": fds})
    tmp = checkpoint_path(dump_dir, fold) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, checkpoint_path(dump_dir, fold))


def load_checkpoint(dump_dir: str, fold: int) -> Dict[str, Any]:
    path = checkpoint_path(dump_dir, fold)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint for fold {fold} in {dump_dir!r}: looked for "
                                f"{os.path.basename(path)}")
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def history_path(dump_dir: str, fold: int) -> str:
    return os.path.join(dump_dir, f"history_{fold}.json")


def _write_history(dump_dir: Optional[str], fold: int, history) -> None:
    """Rewrite the per-epoch scalar log (a few KB) after every epoch (rank
    0 only)."""
    if not dump_dir or not is_writer_process():
        return
    with open(history_path(dump_dir, fold), "w") as f:
        json.dump(history, f, indent=1)



def _load_history(dump_dir: Optional[str], fold: int, upto_epoch: int):
    """A previous run's history rows up to ``upto_epoch`` (1-based); a
    missing or unreadable file gives none."""
    if not dump_dir or not os.path.exists(history_path(dump_dir, fold)):
        return []
    try:
        with open(history_path(dump_dir, fold)) as f:
            rows = json.load(f)
        return [r for r in rows if int(r.get("epoch", 0)) <= upto_epoch]
    except (OSError, ValueError, TypeError, AttributeError):
        return []


# ---- train state ------------------------------------------------------------------

TRAIN_STATE_FORMAT = "mmdti_tpu_torch.train_state.1"


def train_state_path(dump_dir: str, fold: int) -> str:
    return os.path.join(dump_dir, f"train_state_{fold}.ckpt")


def _encode(tree):
    """Tensors -> numpy leaves (a bfloat16 tensor -> {"bfloat16_bits":
    its int16 bits}); dicts, lists and scalars as they are."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {"bfloat16_bits": t.view(torch.int16).numpy()}
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v) for v in tree]
    return tree


def _decode(tree):
    """numpy leaves -> CPU tensors (the inverse of _encode)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        if set(tree) == {"bfloat16_bits"}:
            return torch.from_numpy(tree["bfloat16_bits"].astype(np.int16)).view(torch.bfloat16)
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v) for v in tree]
    return tree


def save_train_state(dump_dir: str, fold: int, state: Dict[str, Any]) -> int:
    """Write ``state`` (a tree of dicts, lists, scalars and CPU tensors or
    arrays) atomically; returns the file's bytes.  Rank 0 writes it; another
    rank writes nothing and gets 0."""
    if not is_writer_process():
        return 0
    os.makedirs(dump_dir, exist_ok=True)
    blob = msgpack_serialize({"format": TRAIN_STATE_FORMAT, **_encode(state)})
    path = train_state_path(dump_dir, fold)
    with open(path + ".tmp", "wb") as f:
        f.write(blob)
    os.replace(path + ".tmp", path)
    return len(blob)


def load_train_state(dump_dir: str, fold: int) -> Dict[str, Any]:
    """The state save_train_state wrote, tensors on the CPU.  A file that
    does not decode, or that another writer made, raises."""
    path = train_state_path(dump_dir, fold)
    with open(path, "rb") as f:
        blob = f.read()
    try:
        tree = unpackb(blob, bfloat16_bits=True)
    except (ValueError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"{path} is not a readable train state ({e}); the resume stops "
                         "here rather than start the fit afresh") from e
    if not isinstance(tree, dict) or tree.get("format") != TRAIN_STATE_FORMAT:
        if isinstance(tree, dict) and "opt_state" in tree:
            raise ValueError(
                f"{path} is the JAX package's train state: its optax optimizer tree maps "
                "onto none of the port's buffers, so the port does not resume it "
                "(ROADMAP.md §3, known differences)")
        raise ValueError(f"{path} is not a train state of this package")
    tree.pop("format")
    return _decode(tree)


class _AsyncSaver:
    """Background train-state writer, one save in flight: ``submit`` waits
    for the previous save first, and a failed write raises at the next
    ``submit`` or ``wait``."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def submit(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # raised at the next join
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True, name="mmdti-ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _host(tree):
    """A tree of tensors pulled to the host (copies)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree


class CheckpointResumeMixin:
    """The fit loop's resume and its epoch-end train-state saves (config on
    the Trainer: resume, checkpoint_interval, stop_after_epoch,
    async_checkpoint, max_epochs).  ``state_saves`` records each save:
    epoch, async, the loop's seconds, the write's seconds and the bytes."""

    def _resume_fit_state(self, dump_dir, fold, programs, train_loader):
        """Copy a saved train state into ``programs`` (TrainPrograms: the
        optimizer's buffers, the FDS and loss state, the generator) in
        place and skip the loader's finished epochs.  Returns (start
        epoch, global step, the saved best state or None)."""
        if not (self.resume and os.path.exists(train_state_path(dump_dir, fold))):
            return 0, 0, None
        state = load_train_state(dump_dir, fold)
        programs.load_state(state["programs"])
        start_epoch = int(state["epoch"]) + 1
        train_loader.advance_epochs(start_epoch)
        logger.info("Resumed train state from epoch %d", start_epoch)
        return start_epoch, int(state["global_step"]), state

    def _save_epoch_state(self, saver: _AsyncSaver, dump_dir, fold, epoch, global_step,
                          programs, best_params, best_fds, min_val_loss, wait,
                          best_score) -> bool:
        """The train state at the end of ``epoch`` (0-based), written every
        checkpoint_interval epochs and when stop_after_epoch ends this run.
        Returns whether it ends (a later resume=True run continues it).

        The tensors are pulled to the host here, on the loop's thread: a
        pull from another thread could meet a CUDA graph capture of this
        one.  With async_checkpoint the encoding and the write then run on
        the writer thread.  Under data parallelism every rank gathers the
        generators' states (a collective) and only rank 0 pulls the rest
        and writes; under tensor parallelism every rank first takes part in
        gathering the whole model's best weights and optimizer buffers over
        its model group."""
        stopping = bool(self.stop_after_epoch and epoch + 1 >= self.stop_after_epoch
                        and epoch + 1 < self.max_epochs)
        interval = bool(self.checkpoint_interval and (epoch + 1) % self.checkpoint_interval == 0)
        if not (interval or stopping):
            return stopping
        t0 = time.perf_counter()
        programs_state = programs.state_dict()
        best_params = model_state(programs.model, best_params)
        if not is_writer_process():
            return stopping
        state = {
            "programs": _host(programs_state),
            "epoch": int(epoch), "global_step": int(global_step),
            "best_params": _host(best_params), "best_fds": _host(best_fds or {}),
            "early_stop": {"min_val_loss": float(min_val_loss), "wait": int(wait),
                           "best_score": float("nan") if best_score is None else float(best_score)},
        }
        record = {"epoch": epoch + 1, "async": bool(self.async_checkpoint and not stopping)}
        self.state_saves.append(record)

        def write():
            t1 = time.perf_counter()
            record["bytes"] = save_train_state(dump_dir, fold, state)
            record["write_s"] = time.perf_counter() - t1

        try:
            # an earlier async save writes the same file: it lands first
            saver.wait()
        except Exception:
            logger.exception("the previous train-state save failed; training continues")
        if record["async"]:
            saver.submit(write)
        else:
            write()
        record["loop_s"] = time.perf_counter() - t0
        return stopping
