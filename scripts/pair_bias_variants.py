#!/usr/bin/env python3
"""Where the time of the bf16 pair-bias attention kernels goes, on one CUDA card.

    python3 scripts/pair_bias_variants.py

Builds mmdti_tpu_torch/csrc/pair_bias_attention.cu as it is and in variants
with one part switched off (a text edit of the source; the results of a
variant are wrong and only its time is read), each into its own library
under build/pair_bias_variants/, and prints each variant's device ms
(torch.profiler, chip_smoke.py's _device_ms) for the tensor-core forward and
backward at B=32, H=64, D=8, bf16, dropout 0.1, N in (64, 256, 272, 280,
288): 272, 280 and 288 take the same 5 x 5 tiles, but only 280's rows (560
bytes) are not 32-byte aligned.  The difference to "base" is what the part
costs where it does not overlap the rest.  Needs nvcc and a card; imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as fut
import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mmdti_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "pair_bias_variants")
SRC = "pair_bias_attention.cu"

# name -> [(old, new, occurrence)], edits of SRC
VARIANTS = {
    "base": [],
    "no dropout hash": [("if constexpr (kDrop)", "if constexpr (false)", 1),
                        ("if constexpr (kDrop)", "if constexpr (false)", 1)],
    "bwd: no dbias store": [
        ("store_pair_tile(a.dbias + pair, ls, qt * kMmaTile, kt * kMmaTile, N, vec);", "", 1)],
    "bwd: no next-stage loads": [("if (s + 1 < stages) load_stage(s + 1, par ^ 1);", "", 1)],
    "fwd: no logits store": [
        ("store_pair_tile(a.logits + pair, pt, row0, it * kMmaTile, N, vec);", "", 1)],
    # the backward's stages in query-tile-major order: its dk/dv sums are then
    # wrong, but its memory order is the one that reads the two key tiles of
    # a row band in consecutive stages
    "bwd: query tiles outermost": [
        ("const int kt = s / T, qt = s - kt * T;", "const int qt = s / T, kt = s - qt * T;", 1),
        ("const int kt = s / T, qt = s - kt * T, par = s & 1;",
         "const int qt = s / T, kt = s - qt * T, par = s & 1;", 1)],
}


def _edit(text, old, new, occurrence):
    at = -1
    for _ in range(occurrence):
        at = text.index(old, at + 1)   # raises when the source no longer has `old`
    return text[:at] + new + text[at + len(old):]


def _build(name, nvcc, flags):
    """Compile one variant; returns its library path."""
    d = os.path.join(OUT, name.replace(" ", "_").replace(":", ""))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
    with open(os.path.join(CSRC, SRC)) as f:
        text = f.read()
    for old, new, n in VARIANTS[name]:
        text = _edit(text, old, new, n)
    with open(os.path.join(d, SRC), "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    # each variant defines the same symbols; keep their function-local
    # statics apart (g++ would make them process-wide)
    cmd = [nvcc, *flags, "-Xcompiler", "-fno-gnu-unique", "-o", so, os.path.join(d, SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pair_bias_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _device_ms
    from mmdti_tpu_torch.ops import _build as build
    from mmdti_tpu_torch.ops import hopper_attention as ha

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with fut.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: _build(n, build.nvcc_path(),
                                                             build.NVCC_FLAGS), VARIANTS)))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, H, D, rate = 32, 64, 8, 0.1
    seed = torch.tensor([123], dtype=torch.int32, device=dev)
    thr, scale = ha.drop.threshold(rate), ha.drop.keep_scale(rate)
    sig = build.SIGNATURES["pair_bias_attention"]
    for N in (64, 256, 272, 280, 288):
        q, k, v, g = (torch.randn(B, N, H * D, generator=gen).to(dev, torch.bfloat16)
                      for _ in range(4))
        bias, gl = (torch.randn(B, H, N, N, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(2))
        out, logits, stats = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, rate)
        o2, l2, s2 = torch.empty_like(q), torch.empty_like(bias), torch.empty_like(stats)
        grads = [torch.empty_like(t) for t in (q, k, v, bias)]
        stream = torch.cuda.current_stream().cuda_stream
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            for fn, argtypes in sig.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int

            def fwd():
                build.check(lib.mmdti_pair_bias_attention_mma_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o2.data_ptr(),
                    l2.data_ptr(), s2.data_ptr(), seed.data_ptr(), thr, scale, B, N, H, D,
                    stream), name)

            def bwd():
                build.check(lib.mmdti_pair_bias_attention_mma_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), logits.data_ptr(),
                    out.data_ptr(), stats.data_ptr(), g.data_ptr(), gl.data_ptr(),
                    *(t.data_ptr() for t in grads), seed.data_ptr(), thr, scale, B, N, H, D,
                    stream), name)

            print(f"N={N} {name:26s} forward {_device_ms(fwd):.4f} ms  "
                  f"backward {_device_ms(bwd):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
