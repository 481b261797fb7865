#!/usr/bin/env python3
"""How often does a torch.profiler window lose or gain kernels on this card?

    python3 scripts/profiler_windows.py [TRIALS]

chip_smoke.py's _device_ms reads device times from profiler windows and
throws a window away unless each kernel name appears exactly n times as
often as in one profiled call.  This script repeats that check TRIALS times
(default 40) for each way of opening a window, on two of the port's kernels
(the bf16 masked-attention backward at ChemBERTa L=512 with dropout, the
bf16 gbf forward at N=64), chip_smoke.py's own way among them, and prints
how many trials held, after the kernel names a window of torch.cuda._sleep
alone holds (chip_smoke.py's spin sentinels).  Needs a card;
imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counts(prof):
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _window(fn, n, activities, sleep_s=0.0):
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(sleep_s)
    return _counts(prof)


def _warm_window(fn, n, activities):
    """One call in the profiler's warm-up step (its events dropped), then n."""
    from torch.profiler import profile, schedule

    got = {}
    with profile(activities=activities, on_trace_ready=lambda p: got.update(_counts(p)),
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_windows.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity

    from chip_smoke import _kernel_events

    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    card, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ways = {
        "card only": lambda f, n: _window(f, n, card),
        "card only, warm-up step": lambda f, n: _warm_window(f, n, card),
        "card only, 20 ms before stop": lambda f, n: _window(f, n, card, 0.02),
        "host and card": lambda f, n: _window(f, n, both),
        "host and card, warm-up step": lambda f, n: _warm_window(f, n, both),
        "chip_smoke.py": lambda f, n: {kn: c for kn, (c, _) in _kernel_events(f, n).items()},
    }
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, L, H, D = 32, 512, 8, 64
    q, k, v, go = (torch.randn(B, L, H * D, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    mask = torch.zeros(B, L, device=dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    out, stats = ha.masked_attention_cuda(q, k, v, mask, H, seed, 0.1)
    N, K = 64, 128
    u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
    params = [torch.rand(K, generator=gen).add(0.5).to(dev) for _ in range(2)]
    params += [torch.randn(*s, generator=gen).mul(0.1).to(dev)
               for s in ((K, K), (K,), (64, K), (64,))]
    fns = {
        "masked bwd L=512": lambda: ha.masked_attention_bwd_cuda(q, k, v, mask, out, stats, go,
                                                                 H, seed, 0.1),
        "gbf fwd N=64": lambda: hg.gbf_pair_bias_fused(u, *params, None, "gelu_tanh",
                                                       torch.bfloat16, torch.bfloat16),
    }
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    print("spin sentinel kernels:", _window(lambda: torch.cuda._sleep(1000), 4, card, 0.02),
          flush=True)
    held = {(f, w): [] for f in fns for w in ways}
    for _ in range(trials):
        for fname, f in fns.items():
            for wname, way in ways.items():
                one, window = way(f, 1), way(f, 20)
                held[(fname, wname)].append(
                    bool(one) and window == {kn: c * 20 for kn, c in one.items()})
    for (fname, wname), oks in held.items():
        print(f"{fname:18s} {wname:30s} held {sum(oks)}/{len(oks)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
