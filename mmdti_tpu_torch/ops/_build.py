"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/lib<name>-<digest>.so`` beside the package (the digest covers
the sources and flags, so an edited kernel rebuilds), with a plain C
interface that ctypes loads: pointers and the stream pass as ``c_void_p``,
ints as ``c_int``, and every entry point returns the ``cudaError_t`` of its
launch.  A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import concurrent.futures as _fut
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# entry point -> argtypes; restype is c_int (a cudaError_t) for all
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "pair_bias_attention": {
        # q, k, v, bias, out, logits, seed, threshold, drop_scale, B, N, H, D,
        # qkv_bf16, pair_bf16, stream
        "mmdti_pair_bias_attention_fwd": (_P,) * 7 + (_U, _F) + (_I,) * 6 + (_P,),
        # q, k, v, logits, g_out, g_logits, dq, dk, dv, dbias, stats, seed,
        # threshold, drop_scale, B, N, H, D, qkv_bf16, pair_bf16, stream
        "mmdti_pair_bias_attention_bwd": (_P,) * 12 + (_U, _F) + (_I,) * 6 + (_P,),
    },
    "masked_attention": {
        # fp32 route (row kernels)
        # q, k, v, mask, out, seed, threshold, drop_scale, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_fwd": (_P,) * 6 + (_U, _F) + (_I,) * 5 + (_P,),
        # q, k, v, mask, g_out, dq, dk, dv, stats, seed, threshold, drop_scale,
        # B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_bwd": (_P,) * 10 + (_U, _F) + (_I,) * 5 + (_P,),
        # bf16 route (tensor cores)
        # q, k, v, mask, out, stats, seed, threshold, drop_scale, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_mma_fwd": (_P,) * 7 + (_U, _F) + (_I,) * 5 + (_P,),
        # q, k, v, mask, out, g_out, stats, rsum, dq, dk, dv, seed, threshold,
        # drop_scale, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_mma_bwd": (_P,) * 12 + (_U, _F) + (_I,) * 5 + (_P,),
    },
    "gbf_proj": {
        # u, means, stds, w1, b1, w2, b2, pad, out, B, N, K, Kh, H,
        # compute_bf16, pair_bf16, act, sqrt_2pi, stream
        "mmdti_gbf_proj_fwd": (_P,) * 9 + (_I,) * 8 + (_F, _P),
        # u, means, stds, w1, b1, w2, pad, g, du, grads, partials, max_blocks,
        # B, N, K, Kh, H, compute_bf16, pair_bf16, act, sqrt_2pi, stream
        "mmdti_gbf_proj_bwd": (_P,) * 11 + (_I,) * 9 + (_F, _P),
    },
    "layer_norm": {
        # x, scale, bias, y, T, E, eps, x_bf16, y_bf16, stream
        "mmdti_layer_norm_fwd": (_P,) * 4 + (_I, _I, _F, _I, _I, _P),
        # x, scale, gy, dx, partials, nblocks, T, E, eps, x_bf16, y_bf16, stream
        "mmdti_layer_norm_bwd": (_P,) * 5 + (_I,) * 3 + (_F, _I, _I, _P),
        # partials, out, nblocks, E, stream
        "mmdti_layer_norm_bwd_reduce": (_P, _P, _I, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from PATH, else the toolkit's default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(name: str):
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, h) for h in headers]


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, compiled on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(_compile(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def build_all() -> Dict[str, str]:
    """Compile every kernel library (in parallel) and load it; returns
    name -> .so path."""
    with _fut.ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        paths = dict(zip(SIGNATURES, pool.map(_compile, SIGNATURES)))
    for name in SIGNATURES:
        load(name)
    return paths


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {rc}")
