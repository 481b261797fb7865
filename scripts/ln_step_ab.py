#!/usr/bin/env python3
"""The flagship train step with the LayerNorm kernels on, for one or more
checkouts of the repository, on one CUDA card.

    python3 scripts/ln_step_ab.py ROOT [ROOT ...]

Each ROOT (a directory holding mmdti_tpu_torch/, for example a `git archive`
of another commit unpacked under build/) runs in its own process, in the
order given, so the same root can be named twice to alternate two versions
(parent, change, change, parent).  Per root: the flagship model (bf16
compute, bf16 pair, weights from seed 0) on a batch of 32 molecules at
N=L=64, regression MSE + InfoNCE + ct_regress, dropout on,
MMDTI_PALLAS_LN=1; 5 warm-up steps, then the step p50 of 20 (CUDA events)
and a torch.profiler window of 3 steps: device ms and kernel launches per
step, and the LayerNorm kernels' (namespace mmdti_ln) ms and launches per
step.  Prints one JSON line per root.  Needs nvcc and a card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SMILES_20 = [
    "CCO", "CC(=O)O", "c1ccccc1", "Cc1ccccc1", "CC(C)O", "CCCC", "CCN",
    "c1ccncc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "C1CCCCC1", "O=C1CCCCC1", "CCOC(=O)C", "CCS", "NCCO", "OCC(O)CO",
    "Clc1ccccc1", "Brc1ccccc1", "FC(F)(F)c1ccccc1", "N#Cc1ccccc1",
]


def one(root: str) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, root)
    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.data.batching import BatchCollator
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.ops import _build
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_step

    _build.build_all()
    os.environ["MMDTI_PALLAS_LN"] = "1"
    dev = torch.device("cuda")
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        compute_dtype="bfloat16", use_kernels=True,
                        unimol_overrides={"pair_dtype": "bfloat16"})
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    model.to(dev)
    B = 32
    smiles = (SMILES_20 * 2)[:B]
    conf = ConformerGen()
    feats = conf.transform(smiles)
    for f, s in zip(feats, smiles):
        f["smile"] = s
    coll = BatchCollator(SmilesTokenizer(), pad_idx=conf.dictionary.pad(), pad_mode="fixed",
                         atom_pad=64, smiles_pad=64)
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    keys = ("src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask")
    batch = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys}
    labels = torch.randn(B, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    weights = torch.ones(B, 1, device=dev)
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, 100, warmup_ratio=0.1, max_norm=1.0)
    step = build_train_step(model, opt, zoo.mse_loss, "regression")
    gen = torch.Generator(device=dev).manual_seed(7)
    args = (batch, labels, weights, gen)
    for _ in range(5):
        step(*args)
    torch.cuda.synchronize()
    events = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(*args)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    ln = [e for e in kernels if "mmdti_ln::" in e.key]
    return {
        "root": root, "step_ms_p50": statistics.median(a.elapsed_time(b) for a, b in events),
        "device_ms_per_step": sum(e.self_device_time_total for e in kernels) / n / 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / n,
        "ln_kernels_ms_per_step": sum(e.self_device_time_total for e in ln) / n / 1e3,
        "ln_kernel_launches_per_step": sum(e.count for e in ln) / n,
        "ln_kernels": {e.key.split("(")[0][-60:]: e.count / n for e in ln},
    }


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
