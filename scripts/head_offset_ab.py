#!/usr/bin/env python3
"""The attention kernels at head offset 0 against the parent commit's, bit
for bit, on one CUDA card.

The tensor-parallel kernels hash a head's dropout bits by its place in the
layer (b*H_total + h0 + h); with h0 = 0 and H_total = H that is the
earlier b*H + h.  This script builds csrc/pair_bias_attention.cu and
csrc/masked_attention.cu of another checkout (the parent commit, unpacked
with ``git archive``) beside this checkout's, launches both through their C
entry points on the same inputs (the flagship's shapes, B=32, N=L=64,
dropout 0.1 and 0, bf16 on the tensor-core route and fp32 on the row
kernels, every forward and backward) and prints, per case, whether every
output is bit-equal, and the card's name and power limit.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/head_offset_ab.py build/parent
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "head_offset_ab")


def _build_other(checkout, src, build):
    """Compile ``checkout``'s csrc/<src> into OUT/<src>.so (its own headers)."""
    csrc = os.path.join(checkout, "mmdti_tpu_torch", "csrc")
    so = os.path.join(OUT, src.replace(".cu", ".so"))
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-I", csrc,
           "-o", so, os.path.join(csrc, src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{src}: nvcc failed\n{proc.stderr[-3000:]}")
    return so


def _old_signatures(build, name):
    """The entry points' argtypes before the head offset: the current ones
    less the two ints (h0, H_total) after drop_scale."""
    out = {}
    for fn, args in build.SIGNATURES[name].items():
        args = list(args)
        at = next(i for i, a in enumerate(args) if a is ctypes.c_float) + 1
        out[fn] = args[:at] + args[at + 2:]
    return out


def main(argv) -> int:
    import torch

    from mmdti_tpu_torch.ops import _build as build
    from mmdti_tpu_torch.ops import dropout as drop

    if not torch.cuda.is_available():
        print("head_offset_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    checkout = argv[1] if len(argv) > 1 else os.path.join(REPO, "build", "parent")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old, new = {}, {}
    for name in ("pair_bias_attention", "masked_attention"):
        lib = ctypes.CDLL(_build_other(checkout, f"{name}.cu", build))
        for fn, argtypes in _old_signatures(build, name).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        old[name], new[name] = lib, build.load(name)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    seed = torch.tensor([20261017], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []

    def run(lib, fn, ptrs, drop_args, ints, extra_new):
        """Call fn with (pointers, dropout args, [h0, H_total], ints)."""
        args = [*ptrs, *drop_args, *(extra_new if lib in new.values() else ()), *ints, stream]
        rc = getattr(lib, fn)(*args)
        if rc:
            raise RuntimeError(f"{fn}: cudaError_t {rc}")

    def compare(case, fn, make, drop_args, ints, H):
        outs = []
        for lib in (old, new):
            tensors, ptrs = make()
            run(lib[case[0]], fn, ptrs, drop_args, ints, (0, H))
            torch.cuda.synchronize()
            outs.append(tensors)
        equal = all(torch.equal(a, b) for a, b in zip(*outs))
        results.append({"case": f"{fn} {case[1]}", "bit_equal": equal})

    def randn(*shape, dt):
        return torch.randn(*shape, generator=gen).to(dev, dt).contiguous()

    B, N, H, D = 32, 64, 64, 8
    for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for rate in (0.1, 0.0):
            drop_args = ((seed.data_ptr(), drop.threshold(rate), drop.keep_scale(rate))
                         if rate else (None, 0, 1.0))
            tag = f"{prec} dropout={rate}"
            q, k, v, go = (randn(B, N, H * D, dt=dt) for _ in range(4))
            bias, gl = randn(B, H, N, N, dt=dt), randn(B, H, N, N, dt=dt)
            stats = torch.empty(B, H, N, 2, dtype=torch.float32, device=dev)
            out = torch.empty_like(q)
            logits = torch.empty_like(bias)
            if prec == "bf16":
                def fwd():
                    o, lg, st = torch.empty_like(q), torch.empty_like(bias), torch.empty_like(stats)
                    return (o, lg, st), [t.data_ptr() for t in (q, k, v, bias, o, lg, st)]
                compare(("pair_bias_attention", f"B={B} N={N} H={H} {tag}"),
                        "mmdti_pair_bias_attention_mma_fwd", fwd, drop_args, (B, N, H, D), H)
                run(new["pair_bias_attention"], "mmdti_pair_bias_attention_mma_fwd",
                    [t.data_ptr() for t in (q, k, v, bias, out, logits, stats)], drop_args,
                    (B, N, H, D), (0, H))

                def bwd():
                    g = [torch.empty_like(t) for t in (q, k, v, bias)]
                    return g, [t.data_ptr() for t in (q, k, v, logits, out, stats, go, gl, *g)]
                compare(("pair_bias_attention", f"B={B} N={N} H={H} {tag}"),
                        "mmdti_pair_bias_attention_mma_bwd", bwd, drop_args, (B, N, H, D), H)
            else:
                def fwd():
                    o, lg = torch.empty_like(q), torch.empty_like(bias)
                    return (o, lg), [t.data_ptr() for t in (q, k, v, bias, o, lg)]
                compare(("pair_bias_attention", f"B={B} N={N} H={H} {tag}"),
                        "mmdti_pair_bias_attention_fwd", fwd, drop_args, (B, N, H, D, 0, 0), H)

                def bwd():
                    g = [torch.empty_like(t) for t in (q, k, v, bias)]
                    ws = torch.empty(B, H, N, 3, dtype=torch.float32, device=dev)
                    return g, [t.data_ptr() for t in (q, k, v, bias, go, gl, *g, ws)]
                compare(("pair_bias_attention", f"B={B} N={N} H={H} {tag}"),
                        "mmdti_pair_bias_attention_bwd", bwd, drop_args, (B, N, H, D, 0, 0), H)
            # masked: ChemBERTa's H=8, D=64
            Hm, Dm = 8, 64
            q, k, v, go = (randn(B, N, Hm * Dm, dt=dt) for _ in range(4))
            mask = torch.zeros(B, N, dtype=torch.float32, device=dev)
            mask[:, 48:] = torch.finfo(torch.float32).min
            ints = (B, N, N, Hm, Dm)
            if prec == "bf16":
                st = torch.empty(B, Hm, N, 2, dtype=torch.float32, device=dev)
                o = torch.empty_like(q)
                run(new["masked_attention"], "mmdti_masked_attention_mma_fwd",
                    [t.data_ptr() for t in (q, k, v, mask, o, st)], drop_args, ints, (0, Hm))

                def mfwd():
                    oo, ss = torch.empty_like(q), torch.empty_like(st)
                    return (oo, ss), [t.data_ptr() for t in (q, k, v, mask, oo, ss)]

                def mbwd():
                    g = [torch.empty_like(t) for t in (q, k, v)]
                    rs = torch.empty(B, Hm, N, dtype=torch.float32, device=dev)
                    return g, [t.data_ptr() for t in (q, k, v, mask, o, go, st, rs, *g)]
                compare(("masked_attention", f"B={B} L={N} H={Hm} {tag}"),
                        "mmdti_masked_attention_mma_fwd", mfwd, drop_args, ints, Hm)
                compare(("masked_attention", f"B={B} L={N} H={Hm} {tag}"),
                        "mmdti_masked_attention_mma_bwd", mbwd, drop_args, ints, Hm)
            else:
                def mfwd():
                    oo = torch.empty_like(q)
                    return (oo,), [t.data_ptr() for t in (q, k, v, mask, oo)]

                def mbwd():
                    g = [torch.empty_like(t) for t in (q, k, v)]
                    ws = torch.empty(B, Hm, N, 3, dtype=torch.float32, device=dev)
                    return g, [t.data_ptr() for t in (q, k, v, mask, go, *g, ws)]
                compare(("masked_attention", f"B={B} L={N} H={Hm} {tag}"),
                        "mmdti_masked_attention_fwd", mfwd, drop_args, ints, Hm)
                compare(("masked_attention", f"B={B} L={N} H={Hm} {tag}"),
                        "mmdti_masked_attention_bwd", mbwd, drop_args, ints, Hm)
    print(json.dumps({"cases": results, "all_bit_equal": all(r["bit_equal"] for r in results)}),
          flush=True)
    return 0 if all(r["bit_equal"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
