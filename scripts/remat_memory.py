#!/usr/bin/env python3
"""The device memory of one eager flagship train step, encoder remat off and
on, at a grid of shapes, and the least-squares fit of the card's memory
model in mmdti_tpu_torch/train/nnmodel.py (STEP_MEMORY) to it.

    python3 scripts/remat_memory.py [--ln 0|1]

Card only (a CUDA device and nvcc; about 2 min with the kernels' build).
The flagship model (bf16 compute, bf16 pair logits, weights from seed 0),
regression MSE + InfoNCE + ct_regress with sample weights, dropout on,
FusedAdam; the LayerNorm kernels on (``--ln 1``, the card's default) or
off (``--ln 0``, as STEP_MEMORY was fitted).
Per shape (B, N, L): the bytes autograd saves in the forward with remat
off (saved-tensor hooks, each storage once, parameters left out), inside
the Uni-Mol layers and outside, pair-sized (N x N) and token-sized; and
the peak allocated by one eager step (loss, gradients, update) with remat
off and on, above what was allocated before the model was built.  Then:
the per-layer coefficients from the hooks (slopes over the shapes),
the other coefficients fitted to the peaks (scipy's non-negative least
squares), each shape's peak beside the fitted model's and beside the
rule's (train/nnmodel.py predicted_step_bytes, its constants as they
are), and the card's name and power limit.  One JSON line each; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (B, N, L): batch rows, atom pad, SMILES pad
GRID = ((32, 64, 64), (64, 64, 64), (128, 64, 64), (256, 64, 64), (32, 160, 64),
        (32, 280, 64), (64, 280, 64), (32, 64, 256))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ln", default="1", choices=("0", "1"),
                    help="MMDTI_PALLAS_LN for the steps (default 1: the LayerNorm kernels)")
    args = ap.parse_args()
    import numpy as np
    import torch
    from scipy.optimize import nnls

    import chip_smoke as cs
    from mmdti_tpu_torch.ops import _build
    from mmdti_tpu_torch.train.nnmodel import predicted_step_bytes

    if not torch.cuda.is_available():
        print("remat_memory.py needs a CUDA device", file=sys.stderr)
        return 2
    os.environ["MMDTI_PALLAS_LN"] = args.ln
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model = cs._flagship(True)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    model.to(dev)
    cfg = model.unimol_cfg
    H, layers = cfg.attention_heads, cfg.encoder_layers
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for B, N, L in GRID:
        res = cs._graph_resident(dev, N, L, B)
        got = cs.remat_peaks(dev, model, res.feats, res.labels, res.weights, gen, base)
        row = {"B": B, "N": N, "L": L, **got}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del res
        torch.cuda.empty_cache()

    # the per-layer terms from the hooks: a layer's saved bytes against its
    # [B,H,N,N] elements and its B*N atoms (the slope; the intercept is the
    # bf16 copies of its weights, which the fit below takes into static)
    pair_layer = float(np.polyfit([r["B"] * H * r["N"] ** 2 for r in rows],
                                  [r["saved"]["layer"]["pair"] / layers for r in rows], 1)[0])
    token_layer = float(np.polyfit([r["B"] * r["N"] for r in rows],
                                   [r["saved"]["layer"]["token"] / layers for r in rows], 1)[0])

    def terms(r):
        return [1.0, r["B"] * r["N"], r["B"] * r["L"]]

    a = np.asarray([terms(r) for r in rows], np.float64)
    chain = np.asarray([r["B"] * layers * pair_layer * H * r["N"] ** 2 for r in rows])
    tokens = np.asarray([r["B"] * token_layer * r["N"] for r in rows])
    off = np.asarray([r["peak"]["off"] for r in rows], np.float64)
    scale = np.abs(a).max(axis=0)
    coef, _ = nnls(a / scale, off - chain - layers * tokens)
    static, token_other, smiles = coef / scale
    fitted_off = a @ (coef / scale) + chain + layers * tokens
    # remat: the chain stays, one layer's tokens (the layer recomputed)
    fitted_on = a @ (coef / scale) + chain + tokens
    memory = {"static": float(static), "pair_layer": float(pair_layer),
              "token_layer": float(token_layer), "token_other": float(token_other),
              "smiles": float(smiles)}
    print(json.dumps({"fit": memory, "ln": args.ln, "card": card}), flush=True)
    for r, fo, fn in zip(rows, fitted_off, fitted_on):
        rule = {way: predicted_step_bytes(r["B"], r["N"], r["L"], cfg, remat=way == "on")
                for way in ("off", "on")}
        print(json.dumps({"B": r["B"], "N": r["N"], "L": r["L"],
                          "off": r["peak"]["off"], "off_fitted": float(fo),
                          "off_err": float(fo / r["peak"]["off"] - 1), "off_rule": rule["off"],
                          "off_rule_err": rule["off"] / r["peak"]["off"] - 1,
                          "on": r["peak"]["on"], "on_fitted": float(fn),
                          "on_err": float(fn / r["peak"]["on"] - 1), "on_rule": rule["on"],
                          "on_rule_err": rule["on"] / r["peak"]["on"] - 1}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
