#!/usr/bin/env python3
"""Where the time of the bf16 (tensor-core) gbf kernels goes, on one CUDA card.

    python3 scripts/gbf_variants.py

Builds mmdti_tpu_torch/csrc/gbf_proj.cu as it is and in variants with one
part switched off (a text edit of the source; the results of a variant are
wrong and only its time is read), each into its own library under
build/gbf_variants/, and prints each variant's device ms (torch.profiler,
chip_smoke.py's _device_ms) for the "mma" forward and backward at B=32,
K = Kh = 128, H=64, gelu_tanh, a bf16 pair, padded keys, N in (64, 280).
The difference to "base" is what the part costs where it does not overlap
the rest.  Needs nvcc and a card; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as fut
import ctypes
import os
import subprocess
import sys

import variant_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "gbf_variants")
SRC = "gbf_proj.cu"

# name -> [(old, new, occurrence)], edits of SRC
VARIANTS = {
    "base": [],
    "no Gaussian ex2": [("return coef * mmdti::ex2_ftz(z * z * (-0.5f * mmdti::kLog2e));",
                         "return coef * z;", 1)],
    "no tanh": [("const float t = tanh_approx(a * (x + c * x * x * x));", "const float t = x;", 1)],
    "fwd: no output store": [("store_tile<P, H>(out, stg, p0, total, NN);", "", 1)],
    "bwd: no cotangent load": [
        ("issue_cotangent<P, H>(go_raw, g, (tile + gridDim.x) * kBT, total, NN);", "", 1),
        ("tile_pad_bits(tm_s, pad, (tile + gridDim.x) * kBT, total, NN, N);", "", 1),
        ("take_cotangent<P, H>(go_s, go_raw, tm_s, db2);", "mmdti::cp_async_wait<0>();", 1)],
    "bwd: no column-sum shuffles": [("const int lane = threadIdx.x & 31;\n  const bool b4",
                                     "return v[0];\n  const int lane = threadIdx.x & 31;\n"
                                     "  const bool b4", 1)],
    "bwd: no dG phase": [("for (int c = 0; c < 64 / kChunk; ++c) {\n      const int k0",
                          "for (int c = 0; c < 0; ++c) {\n      const int k0", 1)],
    "bwd: no weight-grad phase": [
        ("for (int ks = 0; ks < kBT / 16; ++ks) {\n      uint32_t a[2][4];",
         "for (int ks = 0; ks < 0; ++ks) {\n      uint32_t a[2][4];", 1)],
    "bwd: no tile barriers": [
        ("__syncthreads();  // the previous tile", "// the previous tile", 1),
        ("__syncthreads();  // G and the cotangent", "// G and the cotangent", 1),
        ("__syncthreads();  // h and dpre", "// h and dpre", 1),
        ("__syncthreads();  // both halves", "// both halves", 1)],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gbf_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _device_ms
    from mmdti_tpu_torch.ops import _build as build
    from mmdti_tpu_torch.ops import hopper_gbf as hg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with fut.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: variant_build.build(n, VARIANTS[n], SRC, OUT, build.nvcc_path(),
                                          build.NVCC_FLAGS), VARIANTS)))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, K, H = 32, 128, 64
    means, stds = (torch.rand(K, generator=gen).mul(3).add(0.5).to(dev) for _ in range(2))
    w1, b1, w2, b2 = (torch.randn(*s, generator=gen).mul(0.02).to(dev)
                      for s in ((K, K), (K,), (H, K), (H,)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = K * K + H * K + K + H + 2 * K
    grads = torch.empty(sizes, device=dev)
    partials = torch.empty(sms * sizes, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sig = build.SIGNATURES["gbf_proj"]
    act = hg.ACTIVATIONS["gelu_tanh"]
    for N in (64, 280):
        u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
        lens = torch.randint(N // 2, N + 1, (B,), generator=gen)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        g = torch.randn(B, H, N, N, generator=gen).to(dev, torch.bfloat16)
        out, du = torch.empty_like(g), torch.empty_like(u)
        ins = [t.data_ptr() for t in (u, means, stds, w1, b1, w2)]
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            for fn, argtypes in sig.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int

            def fwd():
                build.check(lib.mmdti_gbf_proj_mma_fwd(
                    *ins, b2.data_ptr(), pad.data_ptr(), out.data_ptr(), B, N, H, 1, act,
                    hg.SQRT_2PI, stream), name)

            def bwd():
                build.check(lib.mmdti_gbf_proj_mma_bwd(
                    *ins, pad.data_ptr(), g.data_ptr(), du.data_ptr(), grads.data_ptr(),
                    partials.data_ptr(), sms, B, N, H, 1, act, hg.SQRT_2PI, stream), name)

            print(f"N={N} {name:28s} forward {_device_ms(fwd):.4f} ms  "
                  f"backward {_device_ms(bwd):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
