"""Protocol runner: the 5-seed scaffold-split finetuning protocol of the
repo's finetune.py, on the port.

    python -m mmdti_tpu_torch.finetune --synthetic --task regression

For each seed: random_scaffold_split 80/10/10 -> MolTrain.fit(train, val)
-> MolPredict.predict(test) -> the task's test metric, written to ``--out``
as the seeds finish; the mean is printed last.  Regression scores RMSE
(with FDS and sample weights), classification ROC-AUC, multiclass the
macro one-vs-rest AUC and multilabel classification the NaN-masked column
mean of the AUCs.  ``--synthetic`` writes the same 400-molecule dataset as
finetune.py's for each task (same rows and labels for the same seed).
``--device`` is cuda unless the caller asks for cpu.  ``--unimol-dir`` (a
unicore ``.pt``, with the ``mol.dict.txt`` beside it) and
``--chemberta-dir`` (an HF ChemBERTa dir) fine-tune every seed from
pretrained weights.
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
from mmdti_tpu_torch.utils.metrics import roc_auc_ovr_macro, roc_auc_score

TASKS = ("regression", "classification", "multiclass", "multilabel_classification")
MULTILABEL_COLS = ["t0", "t1", "t2"]


def _terciles(y: np.ndarray) -> np.ndarray:
    """pandas.qcut(y, 3, labels=False): the bin of each value between the
    quantiles 0, 1/3, 2/3 and 1 (right-closed, the lowest edge included)."""
    quantiles = np.linspace(0, 1, 4)
    np.putmask(quantiles, 3 * quantiles != np.arange(4), np.nextafter(quantiles, 1))
    bins = np.quantile(y, quantiles)
    if np.unique(bins).size < bins.size:
        raise ValueError(f"Bin edges must be unique: {bins}")
    ids = np.searchsorted(bins, y, side="left")
    ids[y == bins[0]] = 1
    return (ids - 1).astype(np.int64)


def make_synthetic_dataset(path: str, n: int = 400, seed: int = 0,
                           task: str = "regression") -> None:
    """Solubility-like dataset: diverse scaffolds, a target correlated with
    size and polarity (finetune.py::make_synthetic_dataset).  classification
    cuts the target at its median (a balanced binary label), multiclass
    into terciles, and multilabel_classification writes three binary
    columns from size, heteroatoms and aromatic atoms, with 10 % of t2
    missing.  The multilabel noise draws from a stream of its own, so the
    rows of every task are the same molecules."""
    if task not in TASKS:
        raise ValueError(f"task={task!r} is not one of {TASKS}")
    scaffolds = [
        "c1ccccc1", "C1CCCCC1", "c1ccncc1", "c1ccc2ccccc2c1", "C1CCNCC1",
        "c1ccoc1", "c1ccsc1", "C1CCOC1", "c1cncnc1", "C1CC1", "C1CCC1",
        "C1CCCC1", "c1cnccn1", "C1CCNC1", "c1cc[nH]c1", "C1COCCN1",
        "C1CCOCC1", "c1cscn1", "C1CNCCN1", "c1ccc2[nH]ccc2c1",
    ]
    subs = ["", "C", "CC", "CCC", "O", "N", "Cl", "F", "OC", "C(=O)O", "C(C)C", "CO"]
    rng = np.random.RandomState(seed)
    rng2 = np.random.RandomState(seed + 104729)
    smiles, ys, size, hetero, arom = [], [], [], [], []
    for _ in range(n):
        smi = f"{subs[rng.randint(len(subs))]}{scaffolds[rng.randint(len(scaffolds))]}"
        mol = parse_smiles(smi)
        n_heavy = mol.num_atoms()
        n_hetero = sum(1 for a in mol.atoms if a.symbol not in ("C", "H"))
        n_arom = sum(1 for a in mol.atoms if a.aromatic)
        smiles.append(smi)
        ys.append(-0.2 * n_heavy + 0.8 * n_hetero + rng.randn() * 0.3)
        size.append(n_heavy)
        hetero.append(n_hetero + rng2.randn() * 0.3)
        arom.append(n_arom + rng2.randn() * 0.3)
    table = {"smiles": np.asarray(smiles, dtype=object)}
    y = np.asarray(ys)
    if task == "regression":
        table["measured"] = y
    elif task == "classification":
        table["measured"] = (y > np.median(y)).astype(np.int64)
    elif task == "multiclass":
        table["measured"] = _terciles(y)
    else:
        for col, v in zip(MULTILABEL_COLS, (np.asarray(size), np.asarray(hetero),
                                            np.asarray(arom))):
            table[col] = (v > np.median(v)).astype(np.float64)
        # DataFrame.sample(frac=0.1, random_state=seed): round(0.1 n) rows
        # drawn without replacement
        missing = np.random.RandomState(seed).choice(n, size=round(0.1 * n), replace=False)
        table["t2"][missing] = np.nan
    write_csv(table, path)


def _score_task(task, truth, test_pred, idx):
    """Protocol test metric: RMSE (regression), ROC-AUC (classification),
    macro one-vs-rest AUC (multiclass probabilities; NaN when the test
    split misses a class), NaN-masked column-mean AUC (multilabel; a column
    with one class in the split is skipped)."""
    if task == "regression":
        return float(np.sqrt(np.mean((truth - test_pred.reshape(-1)) ** 2)))
    if task == "multiclass":
        if len(np.unique(truth)) < test_pred.shape[1]:
            print(f"seed {idx}: test split misses a class, macro AUC NaN")
            return float("nan")
        return roc_auc_ovr_macro(truth.reshape(-1), test_pred)
    if task == "multilabel_classification":
        aucs = []
        for j in range(truth.shape[1]):
            m = ~np.isnan(truth[:, j])
            if len(np.unique(truth[m, j])) < 2:
                continue
            aucs.append(roc_auc_score(truth[m, j], test_pred[m, j]))
        if not aucs:
            print(f"seed {idx}: all label columns single-class, AUC NaN")
            return float("nan")
        return float(np.mean(aucs))
    if len(np.unique(truth)) < 2:
        print(f"seed {idx}: test split is single-class, AUC undefined (NaN)")
        return float("nan")
    return roc_auc_score(truth.reshape(-1), test_pred.reshape(-1))


def run_seed(data_path, idx, workdir, *, task="regression", epochs=40, learning_rate=1e-4,
             batch_size=32, early_stopping=20, fds_num=30, target_col="measured",
             smiles_col="smiles", chemberta_dir="", unimol_dir="", arch=None,
             path_overrides=None, device="cuda") -> float:
    """One protocol seed: scaffold split -> MolTrain -> MolPredict -> the
    task's test metric.  FDS and sample weights are regression's only."""
    parts = random_scaffold_split(data_path, random_seed=idx, ratio_test=0.1, ration_valid=0.1)
    paths = {}
    for name, table in zip(("train", "val", "test"), parts):
        paths[name] = os.path.join(workdir, f"{name}_{idx}.csv")
        write_csv(table, paths[name])
    target_cols = MULTILABEL_COLS if task == "multilabel_classification" else [target_col]
    if task == "regression":
        task_kwargs = dict(use_weight=True, all_weight=False, fds=True, fds_num=fds_num,
                           fds_raw_path=paths["train"], fds_col_data=target_col,
                           target_anomaly_check="filter", metrics="mse")
    elif task == "multiclass":
        task_kwargs = dict(metrics="log_loss")
    else:
        task_kwargs = dict(metrics="auc")
    save_path = os.path.join(workdir, f"exp_seed_{idx}")
    clf = MolTrain(
        task=task, epochs=epochs, learning_rate=learning_rate, batch_size=batch_size,
        early_stopping=early_stopping, smiles_col=smiles_col, save_path=save_path,
        target_cols=target_cols, model_name="mm_model", using_infonce=True, using_ct=True,
        raw_data=paths["train"], seed=42, chemberta_dir=chemberta_dir, unimol_dir=unimol_dir,
        device=device, **task_kwargs,
        **(path_overrides or {}), **(arch or {}),
    )
    clf.fit(paths["train"], paths["val"])
    test_pred = MolPredict(load_model=save_path, device=device).predict(paths["test"])
    test = read_csv(paths["test"])
    truth = np.stack([np.asarray(test[c], np.float64) for c in target_cols], axis=1)
    if task in ("regression", "classification"):
        truth = truth.reshape(-1)
    return _score_task(task, truth, np.asarray(test_pred), idx)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=None, help="CSV with smiles + target column")
    ap.add_argument("--task", default="regression", choices=TASKS,
                    help="protocol metric: regression=RMSE, classification=ROC-AUC, "
                         "multiclass=macro OvR AUC (terciles), multilabel_classification="
                         "NaN-masked column-mean AUC (3 binary columns)")
    ap.add_argument("--target-col", default="measured")
    ap.add_argument("--smiles-col", default="smiles")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--early-stopping", type=int, default=20)
    ap.add_argument("--fds-num", type=int, default=30)
    ap.add_argument("--chemberta-dir", default="")
    ap.add_argument("--unimol-dir", default="")
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

    metric_name = "rmse" if args.task == "regression" else "auc"
    scores = []
    for idx in range(args.seed_offset, args.seed_offset + args.seeds):
        score = run_seed(data_path, idx, args.workdir, task=args.task, epochs=args.epochs,
                         learning_rate=args.learning_rate, batch_size=args.batch_size,
                         early_stopping=args.early_stopping, fds_num=args.fds_num,
                         target_col=args.target_col, smiles_col=args.smiles_col,
                         chemberta_dir=args.chemberta_dir, unimol_dir=args.unimol_dir,
                         arch=arch, path_overrides=path_overrides, device=args.device)
        scores.append(score)
        print(f"seed {idx}: test {metric_name.upper()} = {score:.4f}", flush=True)
        seeds_done = np.arange(args.seed_offset, args.seed_offset + len(scores))
        write_csv({"seed": seeds_done, metric_name: np.asarray(scores)}, args.out)
    print(f"mean {metric_name.upper()} over {args.seeds} seeds: {np.nanmean(scores):.4f} -> "
          f"{args.out}")
    return scores


if __name__ == "__main__":
    main()
