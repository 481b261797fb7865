"""Checkpoint files read without ``transformers`` or ``safetensors``.

* An HF model dir (``read_hf_state_dict``): the first of
  ``HF_WEIGHT_FILES`` present, in the order HF's ``from_pretrained``
  prefers them: ``model.safetensors``, its sharded index, then
  ``pytorch_model.bin`` and its sharded index.  Safetensors files are read
  here (an 8-byte little-endian header length, a JSON header, raw
  little-endian bytes); F16 and BF16 tensors are widened to fp32, which is
  exact.  ``.bin`` files load with ``torch.load(weights_only=True)``.  The
  legacy LayerNorm names ``gamma``/``beta`` become ``weight``/``bias``, as
  transformers renames them on load.
* A unicore ``.pt`` (``read_unicore_checkpoint``): ``model``, ``args`` (an
  ``argparse.Namespace``), ``optimizer_history`` and ``extra_state``,
  loaded with ``torch.load(weights_only=True)`` and the named allow-list
  ``UNICORE_GLOBALS``.  A file naming any other class raises: no file is
  unpickled with ``weights_only=False``.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict

import numpy as np
import torch

HF_WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json",
                   "pytorch_model.bin", "pytorch_model.bin.index.json")

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_LEGACY_NAMES = (("LayerNorm.gamma", "LayerNorm.weight"), ("LayerNorm.beta", "LayerNorm.bias"))


def _numpy_globals():
    """numpy's arrays, scalars and dtypes under the names a pickle of numpy
    1 or 2 gives them (a unicore ``extra_state`` may hold numpy values)."""
    core = getattr(np, "_core", None) or np.core
    out = [np.ndarray, np.dtype, *(type(np.dtype(t)) for t in ("f8", "f4", "i8", "i4", "?"))]
    for module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        for fn in ("scalar", "_reconstruct"):
            out.append((getattr(core.multiarray, fn), f"{module}.{fn}"))
    return out


UNICORE_GLOBALS = (argparse.Namespace, *_numpy_globals())


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, floats of 16 bits widened to
    fp32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = memoryview(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this "
                             f"reader does not take ({sorted(_SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        raw = bytearray(data[begin:end])
        t = (torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype))
        t = t.reshape(info["shape"])
        out[name] = t.float() if dtype in (torch.float16, torch.bfloat16) else t
    return out


def _read_weights_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _fix_legacy_name(name: str) -> str:
    for old, new in _LEGACY_NAMES:
        if name.endswith(old):
            return name[: -len(old)] + new
    return name


def read_hf_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF model dir, from the first of HF_WEIGHT_FILES
    it holds (every shard of a sharded one).  A dir with none raises
    FileNotFoundError naming the files looked for."""
    for name in HF_WEIGHT_FILES:
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            break
    else:
        raise FileNotFoundError(f"{model_dir!r} holds no weights file: looked for "
                                f"{', '.join(HF_WEIGHT_FILES)}")
    if name.endswith(".index.json"):
        with open(path, encoding="utf-8") as f:
            shards = dict.fromkeys(json.load(f)["weight_map"].values())
        sd = {}
        for shard in shards:
            sd.update(_read_weights_file(os.path.join(model_dir, shard)))
    else:
        sd = _read_weights_file(path)
    return {_fix_legacy_name(k): v for k, v in sd.items()}


def read_unicore_checkpoint(path: str) -> dict:
    """A unicore checkpoint, read with ``weights_only=True`` and
    UNICORE_GLOBALS allowed."""
    with torch.serialization.safe_globals(list(UNICORE_GLOBALS)):
        return torch.load(path, map_location="cpu", weights_only=True)
