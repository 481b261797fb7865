#!/usr/bin/env python3
"""Can chip_smoke.py's gbf forward check fail a wrong tensor-core kernel?

    python3 scripts/gbf_gate_mutants.py

Builds mmdti_tpu_torch/csrc/gbf_proj.cu as it is and in copies with one
deliberate fault each (a text edit, built under build/gbf_gate_mutants/ with
scripts/variant_build.py), runs each copy's "mma" forward at B=32, N=64,
K = Kh = 128, H=64, gelu_tanh, bf16, padded keys, and holds it to the plain
version at chip_smoke.py's bf16 output tolerance (2e-2 abs).  It does so on
two draws of the weights: as chip_smoke.py draws them (weights and
biases at 0.1, stds U[0.5, 3)) and small (0.02, stds U[0, 3)), where the
part of the output that the GEMMs make is about as large as the tolerance.
Prints, per draw, that part's rms and max, then each copy's error and
whether the check passes it.  Needs nvcc and a card; imports nothing of JAX.
"""

import concurrent.futures as fut
import ctypes
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "gbf_gate_mutants")
sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
import variant_build  # noqa: E402
from chip_smoke import TOL, _err  # noqa: E402
from mmdti_tpu_torch.ops import _build as build  # noqa: E402
from mmdti_tpu_torch.ops import hopper_gbf as hg  # noqa: E402

VARIANTS = {
    "base": [],
    "activation t = x": [("const float t = tanh_approx(a * (x + c * x * x * x));",
                          "const float t = x;", 1)],
    "Gaussian coef x1.25": [("gk[2 * kMK + k] = 1.f / (sqrt_2pi * s);",
                             "gk[2 * kMK + k] = 1.25f / (sqrt_2pi * s);", 1)],
    "GEMM1 skips k < 16, 8 columns": [("mma_bf16(hp[0], ga[ks], b[0], b[1]);",
                                        "if (ks) mma_bf16(hp[0], ga[ks], b[0], b[1]);", 1)],
    "b1 dropped": [("const float2 bb = *reinterpret_cast<const float2*>(b1_s + c * kFwdChunk",
                    "const float2 bb = make_float2(0.f, 0.f); (void)(b1_s + c * kFwdChunk", 1)],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("gbf_gate_mutants.py needs a CUDA device", file=sys.stderr)
        return 2
    with fut.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: variant_build.build(n, VARIANTS[n], "gbf_proj.cu", OUT, build.nvcc_path(),
                                          build.NVCC_FLAGS), VARIANTS)))
    dev = torch.device("cuda")
    B, N, K, H = 32, 64, 128, 64
    atol, rtol = TOL["bf16"]["out"]
    for label, scale, lo in (("chip_smoke draws", 0.1, 0.5), ("small draws", 0.02, 0.0)):
        gen = torch.Generator().manual_seed(1234)
        means = torch.rand(K, generator=gen).mul(3).to(dev)
        stds = torch.rand(K, generator=gen).mul(3 - lo).add(lo).to(dev)
        w1, b1, w2, b2 = (torch.randn(*s, generator=gen).mul(scale).to(dev)
                          for s in ((K, K), (K,), (H, K), (H,)))
        std = stds.abs() + 1e-5
        lens = torch.randint(N // 2, N + 1, (B,), generator=gen)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
        want = hg.gbf_pair_bias_plain(u, means, stds, w1, b1, w2, b2, pad, "gelu_tanh",
                                      torch.bfloat16, torch.bfloat16)
        fin = torch.isfinite(want)
        part = (want.float() - b2[None, :, None, None])[fin]
        print(f"{label}: gemm_part_rms {float(part.square().mean().sqrt()):.5f} "
              f"max {float(part.abs().max()):.5f}", flush=True)
        o = torch.empty_like(want)
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            for fn, argtypes in build.SIGNATURES["gbf_proj"].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            build.check(lib.mmdti_gbf_proj_mma_fwd(
                *(t.data_ptr() for t in (u, means, std, w1, b1, w2, b2, pad)), o.data_ptr(),
                B, N, H, 1, hg.ACTIVATIONS["gelu_tanh"], hg.SQRT_2PI,
                torch.cuda.current_stream().cuda_stream), name)
            torch.cuda.synchronize()
            e, ok = _err(o, want, atol, rtol)
            print(f"  {name:32s} err {e:.5f} tol {atol}  gate {'passes' if ok else 'FAILS'}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
