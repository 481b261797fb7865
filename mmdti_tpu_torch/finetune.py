"""Protocol runner: the 5-seed scaffold-split finetuning protocol of the
repo's finetune.py, on the port.

    python -m mmdti_tpu_torch.finetune --synthetic --task regression

For each seed: random_scaffold_split 80/10/10 -> MolTrain.fit(train, val)
-> MolPredict.predict(test) -> test RMSE, written to ``--out`` as the seeds
finish; the mean RMSE is printed last.  ``--synthetic`` writes the same
400-molecule dataset as finetune.py's (same rows for the same seed).  The
regression protocol is ported; the other tasks raise until their slice
(ROADMAP.md, M5).  ``--device`` is cuda unless the caller asks for cpu.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from mmdti_tpu_torch.api.predict_api import MolPredict
from mmdti_tpu_torch.api.train_api import MolTrain
from mmdti_tpu_torch.chem.smiles import parse_smiles
from mmdti_tpu_torch.data.reader import read_csv, write_csv
from mmdti_tpu_torch.splits import random_scaffold_split

TASKS = ("regression",)


def make_synthetic_dataset(path: str, n: int = 400, seed: int = 0,
                           task: str = "regression") -> None:
    """Solubility-like dataset: diverse scaffolds, a target correlated with
    size and polarity (finetune.py::make_synthetic_dataset, regression)."""
    if task not in TASKS:
        raise NotImplementedError(f"task={task!r} is not ported yet (ROADMAP.md, M5)")
    scaffolds = [
        "c1ccccc1", "C1CCCCC1", "c1ccncc1", "c1ccc2ccccc2c1", "C1CCNCC1",
        "c1ccoc1", "c1ccsc1", "C1CCOC1", "c1cncnc1", "C1CC1", "C1CCC1",
        "C1CCCC1", "c1cnccn1", "C1CCNC1", "c1cc[nH]c1", "C1COCCN1",
        "C1CCOCC1", "c1cscn1", "C1CNCCN1", "c1ccc2[nH]ccc2c1",
    ]
    subs = ["", "C", "CC", "CCC", "O", "N", "Cl", "F", "OC", "C(=O)O", "C(C)C", "CO"]
    rng = np.random.RandomState(seed)
    smiles, ys = [], []
    for _ in range(n):
        smi = f"{subs[rng.randint(len(subs))]}{scaffolds[rng.randint(len(scaffolds))]}"
        mol = parse_smiles(smi)
        n_heavy = mol.num_atoms()
        n_hetero = sum(1 for a in mol.atoms if a.symbol not in ("C", "H"))
        smiles.append(smi)
        ys.append(-0.2 * n_heavy + 0.8 * n_hetero + rng.randn() * 0.3)
    write_csv({"smiles": np.asarray(smiles, dtype=object), "measured": np.asarray(ys)}, path)


def run_seed(data_path, idx, workdir, *, task="regression", epochs=40, learning_rate=1e-4,
             batch_size=32, early_stopping=20, fds_num=30, target_col="measured",
             smiles_col="smiles", arch=None, path_overrides=None, device="cuda") -> float:
    """One protocol seed: scaffold split -> MolTrain -> MolPredict -> test
    RMSE."""
    if task not in TASKS:
        raise NotImplementedError(f"task={task!r} is not ported yet (ROADMAP.md, M5)")
    parts = random_scaffold_split(data_path, random_seed=idx, ratio_test=0.1, ration_valid=0.1)
    paths = {}
    for name, table in zip(("train", "val", "test"), parts):
        paths[name] = os.path.join(workdir, f"{name}_{idx}.csv")
        write_csv(table, paths[name])
    save_path = os.path.join(workdir, f"exp_seed_{idx}")
    clf = MolTrain(
        task=task, epochs=epochs, learning_rate=learning_rate, batch_size=batch_size,
        early_stopping=early_stopping, smiles_col=smiles_col, save_path=save_path,
        target_cols=[target_col], model_name="mm_model", using_infonce=True, using_ct=True,
        raw_data=paths["train"], seed=42, use_weight=True, all_weight=False, fds=True,
        fds_num=fds_num, fds_raw_path=paths["train"], fds_col_data=target_col,
        target_anomaly_check="filter", metrics="mse", device=device,
        **(path_overrides or {}), **(arch or {}),
    )
    clf.fit(paths["train"], paths["val"])
    test_pred = MolPredict(load_model=save_path, device=device).predict(paths["test"])
    truth = np.asarray(read_csv(paths["test"])[target_col], np.float64)
    return float(np.sqrt(np.mean((truth - np.asarray(test_pred).reshape(-1)) ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=None, help="CSV with smiles + target column")
    ap.add_argument("--task", default="regression", choices=TASKS)
    ap.add_argument("--target-col", default="measured")
    ap.add_argument("--smiles-col", default="smiles")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--early-stopping", type=int, default=20)
    ap.add_argument("--fds-num", type=int, default=30)
    ap.add_argument("--out", default="result.csv")
    ap.add_argument("--workdir", default="./finetune_runs")
    ap.add_argument("--synthetic", action="store_true", help="generate a synthetic dataset")
    ap.add_argument("--small", action="store_true", help="small architecture (debug)")
    ap.add_argument("--use-pallas", default="auto", choices=["auto", "true", "false"],
                    help="kernel path: auto/true (Hopper kernels on cuda), false = the "
                         "plain path")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="first split seed (protocol seeds are offset..offset+seeds-1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    os.makedirs(args.workdir, exist_ok=True)
    data_path = args.data
    if data_path is None or args.synthetic:
        data_path = os.path.join(args.workdir, "synthetic.csv")
        make_synthetic_dataset(data_path, task=args.task)
        print(f"Generated synthetic dataset at {data_path}")
    arch = {}
    if args.small:
        arch = dict(
            unimol_overrides={"encoder_layers": 2, "embed_dim": 64, "ffn_embed_dim": 128,
                              "attention_heads": 8},
            chemberta_overrides={"hidden_size": 64, "num_hidden_layers": 2,
                                 "num_attention_heads": 4, "intermediate_size": 128},
        )
    path_overrides = {"compute_dtype": args.compute_dtype}
    if args.use_pallas != "auto":
        path_overrides["use_pallas"] = args.use_pallas == "true"

    scores = []
    for idx in range(args.seed_offset, args.seed_offset + args.seeds):
        score = run_seed(data_path, idx, args.workdir, task=args.task, epochs=args.epochs,
                         learning_rate=args.learning_rate, batch_size=args.batch_size,
                         early_stopping=args.early_stopping, fds_num=args.fds_num,
                         target_col=args.target_col, smiles_col=args.smiles_col, arch=arch,
                         path_overrides=path_overrides, device=args.device)
        scores.append(score)
        print(f"seed {idx}: test RMSE = {score:.4f}", flush=True)
        seeds_done = np.arange(args.seed_offset, args.seed_offset + len(scores))
        write_csv({"seed": seeds_done, "rmse": np.asarray(scores)}, args.out)
    print(f"mean RMSE over {args.seeds} seeds: {np.nanmean(scores):.4f} -> {args.out}")
    return scores


if __name__ == "__main__":
    main()
