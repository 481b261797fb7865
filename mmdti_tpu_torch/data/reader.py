"""Molecular data reading (port of mmdti_tpu/data/reader.py) over column
tables instead of DataFrames.

A table is a dict of column name -> 1-D numpy array, in column order.
``read_csv`` types a column as int64 when every cell is an integer, float64
when every non-empty cell is a number (empty cells become NaN, which the
multilabel masks rely on), and str otherwise.  ``MolDataReader.read_data``
takes a CSV path, a dict of columns, a table or a list of SMILES; filters
invalid SMILES before it extracts targets, so targets, SMILES and scaffolds
stay aligned; adds -1.0 placeholder columns for missing targets at predict
time; 3-sigma-cleans regression targets; and computes scaffold keys.
"""

from __future__ import annotations

import csv
import logging
import math
from typing import Any, Dict, List, Sequence

import numpy as np

from mmdti_tpu_torch.chem.scaffold import murcko_scaffold
from mmdti_tpu_torch.chem.smiles import is_valid_smiles

logger = logging.getLogger("mmdti_tpu_torch")

Table = Dict[str, np.ndarray]


def _typed_column(cells: List[str]) -> np.ndarray:
    try:
        if all(c.strip() for c in cells):
            return np.asarray([int(c) for c in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(c) if c.strip() else math.nan for c in cells],
                          dtype=np.float64)
    except ValueError:
        return np.asarray(cells, dtype=object)


def read_csv(path: str) -> Table:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: _typed_column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (np.integer,)):
        return str(int(v))
    return str(v)


def write_csv(table: Table, path: str, index: bool = False) -> None:
    """Write a table as pandas' ``to_csv`` does (floats by repr, NaN as an
    empty cell; ``index=True`` adds the unnamed row-number column first)."""
    cols = list(table)
    n = num_rows(table)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + cols)
        for i in range(n):
            w.writerow(([str(i)] if index else []) + [_cell(table[c][i]) for c in cols])


def num_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take_rows(table: Table, idx) -> Table:
    idx = np.asarray(idx, dtype=np.int64)
    return {k: np.asarray(v)[idx] for k, v in table.items()}


def as_table(data) -> Table:
    """A CSV path, a table or a dict of sequences -> a table."""
    if isinstance(data, str):
        return read_csv(data)
    return {k: np.asarray(v) if not isinstance(v, np.ndarray) else v.copy()
            for k, v in dict(data).items()}


class MolDataReader:
    def read_data(self, data=None, is_train: bool = True, **params) -> Dict[str, Any]:
        task = params.get("task", None)
        target_cols = params.get("target_cols", None)
        if isinstance(target_cols, str):
            target_cols = [c for c in target_cols.split(",") if c]
        smiles_col = params.get("smiles_col", "SMILES")
        target_col_prefix = params.get("target_col_prefix", "TARGET")
        anomaly_clean = params.get("anomaly_clean", False)
        smi_strict = params.get("smi_strict", False)
        split_group_col = params.get("split_group_col", "scaffold")

        if isinstance(data, str):
            data = read_csv(data)
        elif isinstance(data, dict):
            data = dict(data)
            if "target" in data:
                label = np.array(data.pop("target"))
                if label.ndim == 1 or label.shape[1] == 1:
                    data[target_col_prefix] = label.reshape(-1)
                else:
                    for i in range(label.shape[1]):
                        data[target_col_prefix + str(i)] = label[:, i]
            data = {("SMILES" if k == smiles_col else k): np.asarray(v) for k, v in data.items()}
            smiles_col = "SMILES"
        elif isinstance(data, (list, tuple)):
            data = {"SMILES": np.asarray(list(data), dtype=object)}
            smiles_col = "SMILES"
        else:
            raise ValueError(f"Unknown data type: {type(data)}")

        # SMILES validity filter first, keeping everything aligned
        if smiles_col in data:
            mask = np.asarray([self.check_smiles(str(s), is_train, smi_strict)
                               for s in data[smiles_col]], dtype=bool)
            if not mask.all():
                data = take_rows(data, np.flatnonzero(mask))

        if task == "repr":
            targets = target_cols = num_classes = multiclass_cnt = None
        else:
            if target_cols is None:
                target_cols = [c for c in data if c.startswith(target_col_prefix)]
            else:
                # predict-time placeholder, filled per missing column
                for col in target_cols:
                    if col not in data:
                        data[col] = np.full(num_rows(data), -1.0)
            if is_train and anomaly_clean:
                data = self.anomaly_clean(data, task, target_cols)
            multiclass_cnt = (
                int(np.nanmax(np.stack([np.asarray(data[c], np.float64) for c in target_cols]))
                    + 1) if (is_train and task == "multiclass") else None
            )
            targets = np.stack([np.asarray(data[c]) for c in target_cols], axis=1).tolist()
            num_classes = len(target_cols)

        dd: Dict[str, Any] = {
            "raw_data": data,
            "raw_target": targets,
            "num_classes": num_classes,
            "target_cols": target_cols,
            "multiclass_cnt": multiclass_cnt,
        }
        if smiles_col in data:
            dd["smiles"] = [str(s) for s in data[smiles_col]]
            dd["scaffolds"] = [murcko_scaffold(s) for s in dd["smiles"]]
        else:
            dd["smiles"] = None
            dd["scaffolds"] = None

        if split_group_col in data:
            dd["group"] = list(data[split_group_col])
        elif split_group_col == "scaffold":
            dd["group"] = dd["scaffolds"]
        else:
            dd["group"] = None

        if "atoms" in data and "coordinates" in data:
            dd["atoms"] = list(data["atoms"])
            dd["coordinates"] = list(data["coordinates"])
        return dd

    def check_smiles(self, smi: str, is_train: bool, smi_strict: bool) -> bool:
        if not is_valid_smiles(smi):
            if is_train and not smi_strict:
                logger.info(f"Illegal SMILES clean: {smi}")
                return False
            raise ValueError(f"SMILES rule is illegal: {smi}")
        return True

    def anomaly_clean(self, data: Table, task: str, target_cols: Sequence[str]) -> Table:
        if task in ("classification", "multiclass", "multilabel_classification",
                    "multilabel_regression"):
            return data
        if task == "regression":
            col = np.asarray(data[target_cols[0]], dtype=np.float64)
            valid = col[~np.isnan(col)]
            mean = valid.mean() if valid.size else math.nan
            std = valid.std(ddof=1) if valid.size > 1 else math.nan
            if not np.isfinite(std) or std == 0.0:
                logger.info("Anomaly clean skipped: target std is %s", std)
                return data
            keep = (col > mean - 3 * std) & (col < mean + 3 * std)
            out = take_rows(data, np.flatnonzero(keep))
            logger.info("Anomaly clean with 3 sigma threshold: %d -> %d", len(col),
                        num_rows(out))
            return out
        raise ValueError(f"Unknown task: {task}")
