"""Best-weights checkpoint and per-epoch history (port of the matching
parts of mmdti_tpu/train/checkpointing.py).

``model_{fold}.ckpt`` keeps the JAX package's flax-msgpack format:
``{"params": <flax parameter tree>, "fds": {<FDS state>}}``, each array as
msgpack extension type 1 holding the msgpack triple (shape, dtype name,
C-order bytes), as ``flax.serialization.msgpack_serialize`` writes it.  The
small codec below writes and reads exactly that (maps, arrays, str, bin,
int, float, bool, nil, ext) without the msgpack package, so either package
restores the other's checkpoint.  The parameter names are the flax paths
that models/convert.py maps onto the port's state dict.
``history_{fold}.json`` is the per-epoch scalar log.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

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
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

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
                raise ValueError("bfloat16 arrays are not read by this codec")
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


def unpackb(data: bytes, raw: bool = False):
    r = _Reader(data, raw)
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
    ``fds_state`` a dict of arrays or tensors, or None."""
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
    """Rewrite the per-epoch scalar log (a few KB) after every epoch."""
    if not dump_dir:
        return
    with open(history_path(dump_dir, fold), "w") as f:
        json.dump(history, f, indent=1)

