"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/lib<name>-<digest>.so`` beside the package (the digest covers
the sources and flags, so an edited kernel rebuilds), with a plain C
interface that ctypes loads: pointers and the stream pass as ``c_void_p``,
ints as ``c_int``, and every entry point returns the ``cudaError_t`` of its
launch.  A failed build raises with nvcc's output; nothing falls back.
A library in ``PARTS`` compiles as several objects at once, each defining
some of its entry points, linked into the one library.

The host chemistry library (``csrc/mmchem.cpp``, chem/native.py) takes the
host-compiler route, ``build_host_library``: g++ (``$CXX``) with the flags of
the JAX package's csrc/Makefile, into ``build/kernels/lib<name>-<digest>.so``
under a file lock, so that concurrent test processes build it once.
"""

from __future__ import annotations

import concurrent.futures as _fut
import ctypes
import fcntl
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
        # fp32 route (row kernels)
        # q, k, v, bias, out, logits, seed, threshold, drop_scale, h0, H_total, B, N, H, D,
        # qkv_bf16, pair_bf16, stream
        "mmdti_pair_bias_attention_fwd": (_P,) * 7 + (_U, _F) + (_I,) * 8 + (_P,),
        # q, k, v, logits, g_out, g_logits, dq, dk, dv, dbias, stats, seed,
        # threshold, drop_scale, h0, H_total, B, N, H, D, qkv_bf16, pair_bf16, stream
        "mmdti_pair_bias_attention_bwd": (_P,) * 12 + (_U, _F) + (_I,) * 8 + (_P,),
        # bf16 route (tensor cores)
        # q, k, v, bias, out, logits, stats, seed, threshold, drop_scale, h0, H_total,
        # B, N, H, D, stream
        "mmdti_pair_bias_attention_mma_fwd": (_P,) * 8 + (_U, _F) + (_I,) * 6 + (_P,),
        # q, k, v, logits, out, stats, g_out, g_logits, dq, dk, dv, dbias, seed,
        # threshold, drop_scale, h0, H_total, B, N, H, D, stream
        "mmdti_pair_bias_attention_mma_bwd": (_P,) * 13 + (_U, _F) + (_I,) * 6 + (_P,),
    },
    "masked_attention": {
        # fp32 route (row kernels)
        # q, k, v, mask, out, seed, threshold, drop_scale, h0, H_total, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_fwd": (_P,) * 6 + (_U, _F) + (_I,) * 7 + (_P,),
        # q, k, v, mask, g_out, dq, dk, dv, stats, seed, threshold, drop_scale,
        # h0, H_total, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_bwd": (_P,) * 10 + (_U, _F) + (_I,) * 7 + (_P,),
        # bf16 route (tensor cores)
        # q, k, v, mask, out, stats, seed, threshold, drop_scale, h0, H_total, B, Nq,
        # Nk, H, D, stream
        "mmdti_masked_attention_mma_fwd": (_P,) * 7 + (_U, _F) + (_I,) * 7 + (_P,),
        # q, k, v, mask, out, g_out, stats, rsum, dq, dk, dv, seed, threshold,
        # drop_scale, h0, H_total, B, Nq, Nk, H, D, stream
        "mmdti_masked_attention_mma_bwd": (_P,) * 12 + (_U, _F) + (_I,) * 7 + (_P,),
    },
    "gbf_proj": {
        # u, means, stds, w1, b1, w2, b2, pad, out, B, N, K, Kh, H,
        # compute_bf16, pair_bf16, act, sqrt_2pi, stream
        "mmdti_gbf_proj_fwd": (_P,) * 9 + (_I,) * 8 + (_F, _P),
        # u, means, stds, w1, b1, w2, pad, g, du, grads, partials, max_blocks,
        # B, N, K, Kh, H, compute_bf16, pair_bf16, act, sqrt_2pi, stream
        "mmdti_gbf_proj_bwd": (_P,) * 11 + (_I,) * 9 + (_F, _P),
        # bf16 route (tensor cores)
        # u, means, stds, w1, b1, w2, b2, pad, out, B, N, H, pair_bf16, act,
        # sqrt_2pi, stream
        "mmdti_gbf_proj_mma_fwd": (_P,) * 9 + (_I,) * 5 + (_F, _P),
        # u, means, stds, w1, b1, w2, pad, g, du, grads, partials, max_blocks,
        # B, N, H, pair_bf16, act, sqrt_2pi, stream
        "mmdti_gbf_proj_mma_bwd": (_P,) * 11 + (_I,) * 6 + (_F, _P),
    },
    "layer_norm": {
        # x, scale, bias, y, T, E, eps, x_bf16, y_bf16, grid, stream
        "mmdti_layer_norm_fwd": (_P,) * 4 + (_I, _I, _F, _I, _I, _I, _P),
        # x, scale, gy, dx, grads, cluster_rows, ticket, T, E, eps, x_bf16, y_bf16,
        # grid, stream
        "mmdti_layer_norm_bwd": (_P,) * 7 + (_I, _I, _F, _I, _I, _I, _P),
        # backward, E, x_bf16, y_bf16, blocks (out)
        "mmdti_layer_norm_resident": (_I,) * 4 + (ctypes.POINTER(_I),),
    },
    "trace_mark": {
        # which (train/profiler.py MARKS index), stream
        "mmdti_trace_mark": (_I, _P),
    },
}

# libraries built in parts: csrc/<name>.cu compiled this many times at once,
# with MMDTI_PART = 0, 1, ... (each part defines some of the entry points and
# instantiates only their kernels), and the objects linked into one library
PARTS: Dict[str, int] = {"gbf_proj": 4}

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
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, f"parts={PARTS.get(name, 1)}")).encode())
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
    src = os.path.join(CSRC, f"{name}.cu")
    parts = PARTS.get(name)
    if parts is None:
        runs = [_nvcc([*NVCC_FLAGS, "-o", tmp, src])]
    else:
        # the parts' objects at once, then one link
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [f"{tmp}.part{i}.o" for i in range(parts)]
        with _fut.ThreadPoolExecutor(max_workers=parts) as pool:
            runs = list(pool.map(
                lambda i: _nvcc([*compile_flags, "-c", f"-DMMDTI_PART={i}", "-o", objs[i], src]),
                range(parts)))
        if all(code == 0 for _, code, _ in runs):
            runs.append(_nvcc([*NVCC_FLAGS, "-o", tmp, *objs]))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write("".join(cmd + "\n" + text for cmd, _, text in runs))
    failed = [(cmd, code, text) for cmd, code, text in runs if code != 0]
    if failed:
        cmd, code, text = failed[0]
        raise RuntimeError(f"nvcc failed to build {name}.cu (exit {code}):\n{text}")
    os.replace(tmp, out)
    return out


def _nvcc(args):
    """(command line, exit code, output) of one nvcc run."""
    cmd = [nvcc_path(), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return " ".join(cmd), proc.returncode, proc.stdout + proc.stderr


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


# the JAX package's csrc/Makefile flags; no -march: a library built with
# -march=native on one host can SIGILL on another
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def host_compiler() -> str:
    """The C++ compiler: ``$CXX`` as make reads it, else g++."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the host chemistry library "
                           "needs one")
    return found


def host_library_path(name: str) -> str:
    """Where ``csrc/<name>.cpp`` builds to: a digest of the compiler, the
    flags and the source names it."""
    digest = hashlib.sha256(" ".join((host_compiler(), *HOST_CXX_FLAGS)).encode())
    with open(os.path.join(CSRC, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_host_library(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless its
    library is built already; returns the .so path.  A file lock keeps
    concurrent processes to one build, and the finished library is renamed
    into place, so no process loads a half-written file.  A failed build
    raises with the compiler's output."""
    out = host_library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"lib{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [host_compiler(), *HOST_CXX_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cmd[0]} failed to build {name}.cpp (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


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
