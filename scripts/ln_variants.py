#!/usr/bin/env python3
"""Where the time of the LayerNorm kernels goes, on one CUDA card.

    python3 scripts/ln_variants.py [variant ...]

Builds mmdti_tpu_torch/csrc/layer_norm.cu as it is and in variants with one
part switched off (a text edit of the source; the results of such a variant
are wrong and only its time is read), each into its own library under
build/ln_variants/, and prints each variant's device ms (torch.profiler,
chip_smoke.py's _device_ms) for the forward and the one-launch backward,
bf16 x and y, E=512, at T=2048 and 8960, at the wrapper's grids and at
others.  The difference to "base" is what the part costs where it does not
overlap the rest.  Needs nvcc and a card; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as fut
import ctypes
import os
import subprocess
import sys

import variant_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "ln_variants")
SRC = "layer_norm.cu"

# name -> [(old, new, occurrence)], edits of SRC
WAIT = '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
VARIANTS = {
    "base": [],
    "bwd: return after the rows": [("  // the warps' rows [kWarps][2E] over the ring",
                                    WAIT + "  return;\n  // the warps' rows", 1)],
    "bwd: return after the cluster barrier": [
        ("  // this rank's slice of the cluster's row",
         "  return;\n  // this rank's slice of the cluster's row", 1)],
    "bwd: return after the cluster rows": [("  // Thread 0 takes a ticket",
                                            "  return;\n  // Thread 0 takes a ticket", 1)],
    "bwd: no last-block sums": [("  if (!s_last) return;", "  return;", 1)],
    "bwd: last-block sums one load at a time": [("constexpr int kBatch = 16;",
                                                 "constexpr int kBatch = 1;", 1)],
    "bwd: no fences": [("    __threadfence();\n    s_last = atomicAdd", "    s_last = atomicAdd",
                        1),
                       ("      __threadfence();\n    }\n  }", "    }\n  }", 1)],
    "ring of 4 rows": [("constexpr int kStages = 3;", "constexpr int kStages = 4;", 1),
                       ('static_assert(kBwd <= kMaxSmemBytes, "backward ring too large");', "",
                        1)],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ln_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _device_ms
    from mmdti_tpu_torch.ops import _build as build
    from mmdti_tpu_torch.ops import hopper_ln as hl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)   # "base" and the named ones
    names = ["base"] + [n for n in names if n != "base"]
    with fut.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda n: variant_build.build(n, VARIANTS[n], SRC, OUT, build.nvcc_path(),
                                          build.NVCC_FLAGS), names)))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    E = 512
    w = (torch.rand(E, generator=gen) + 0.5).to(dev)
    b = (torch.randn(E, generator=gen) * 0.1).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    sig = build.SIGNATURES["layer_norm"]
    resident = {k: hl._resident(dev, k, E, 1, 1) for k in (0, 1)}
    print(f"resident blocks: forward {resident[0]}, backward {resident[1]}", flush=True)
    for T in (2048, 8960):
        x = torch.randn(T, E, generator=gen).to(dev, torch.bfloat16)
        gy = torch.randn(T, E, generator=gen).to(dev, torch.bfloat16)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        grads = torch.empty(2 * E, device=dev)
        bgrids = sorted({hl.backward_grid(T, resident[1]), hl.backward_grid(T, 128),
                         min(8 * -(-T // 64), resident[1] // 8 * 8)})
        fgrids = sorted({hl.forward_grid(T, resident[0]), 132, 264, 396, 528, 792})
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            for fn, argtypes in sig.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            blocks = ctypes.c_int(0)
            build.check(lib.mmdti_layer_norm_resident(1, E, 1, 1, ctypes.byref(blocks)), name)
            build.check(lib.mmdti_layer_norm_resident(0, E, 1, 1, ctypes.byref(blocks)), name)
            times = []
            for grid in bgrids:
                rows = torch.empty(grid // hl.CLUSTER, 2 * E, device=dev)
                ticket = torch.zeros(hl.CLUSTER, dtype=torch.int32, device=dev)

                def bwd():
                    build.check(lib.mmdti_layer_norm_bwd(
                        x.data_ptr(), w.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                        grads.data_ptr(), rows.data_ptr(), ticket.data_ptr(), T, E, 1e-5, 1, 1,
                        grid, stream), name)

                times.append(f"bwd grid {grid} {_device_ms(bwd):.5f}")
            if name == "base":
                for grid in fgrids:
                    def fwd():
                        build.check(lib.mmdti_layer_norm_fwd(
                            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), T, E, 1e-5,
                            1, 1, grid, stream), name)

                    times.append(f"fwd grid {grid} {_device_ms(fwd):.5f}")
            print(f"T={T} {name:36s} " + "  ".join(times) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
