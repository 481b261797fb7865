#!/usr/bin/env python3
"""One seed of the synthetic multilabel_classification protocol
(mmdti_tpu_torch.finetune, 40 epochs, flagship width, bf16) run several
ways on the card, to tell a hard split from a fault in the port:

* ``kernel``: the protocol as ``python -m mmdti_tpu_torch.finetune`` runs
  it (the Hopper kernels, pair features built on the card);
* ``kernel_host_pairs``: the same with the host's pair arrays
  (``device_pair_feats="host"``), as the protocol ran before the card
  built them;
* ``plain``: the plain PyTorch path (``use_pallas=False``);
* ``no_dropout``: the kernel path with every dropout 0 (the encoders',
  the heads' and InfoNCE's query dropout, which has no config key and is
  set here as tests/test_torch_fit.py sets it).

    python3 scripts/multilabel_seed.py --seed 5 [--ways kernel,plain,...]

Prints one JSON line a way (the seed's masked column-mean test AUC and its
wall seconds), then all of them as one line, also written to
<workdir>/seed<seed>.json (build/multilabel_seed by default).
"""

import argparse
import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAYS = ("kernel", "kernel_host_pairs", "plain", "no_dropout")
NO_DROPOUT = dict(
    unimol_overrides={"dropout": 0.0, "emb_dropout": 0.0, "attention_dropout": 0.0,
                      "activation_dropout": 0.0, "pooler_dropout": 0.0},
    chemberta_overrides={"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    crossmodal_overrides={"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--ways", default=",".join(WAYS))
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "multilabel_seed"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    import torch

    import mmdti_tpu_torch.models.mm_model as mm
    from mmdti_tpu_torch.finetune import make_synthetic_dataset, run_seed

    if not torch.cuda.is_available():
        raise SystemExit("scripts/multilabel_seed.py needs a CUDA device")
    os.makedirs(args.workdir, exist_ok=True)
    data = os.path.join(args.workdir, "synthetic.csv")
    make_synthetic_dataset(data, task="multilabel_classification")
    real_infonce = mm.InfoNCE
    results = {"seed": args.seed, "epochs": args.epochs,
               "device": torch.cuda.get_device_name(0), "ways": {}}
    for way in args.ways.split(","):
        if way not in WAYS:
            raise SystemExit(f"unknown way {way!r}: expected one of {WAYS}")
        overrides = {"compute_dtype": "bfloat16"}
        arch = None
        if way == "kernel_host_pairs":
            overrides["device_pair_feats"] = "host"
        elif way == "plain":
            overrides["use_pallas"] = False
        elif way == "no_dropout":
            arch = NO_DROPOUT
        mm.InfoNCE = (functools.partial(real_infonce, embed_dropout=0.0)
                      if way == "no_dropout" else real_infonce)
        workdir = os.path.join(args.workdir, way)
        os.makedirs(workdir, exist_ok=True)
        t0 = time.perf_counter()
        auc = run_seed(data, args.seed, workdir, task="multilabel_classification",
                       epochs=args.epochs, arch=arch, path_overrides=overrides)
        results["ways"][way] = {"auc": auc, "seconds": time.perf_counter() - t0}
        print(json.dumps({"way": way, **results["ways"][way]}), flush=True)
    mm.InfoNCE = real_infonce
    with open(os.path.join(args.workdir, f"seed{args.seed}.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
