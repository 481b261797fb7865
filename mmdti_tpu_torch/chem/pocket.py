"""Featurization of a docking complex (models/docking.py): the pocket's
atoms under the pocket dictionary, and the distance targets of a holo pose.

The pocket is cropped at ``max_atoms`` by keeping the atoms nearest the
pocket's centre (the mean of its coordinates), in their original order: an
assumed rule (Uni-Mol crops by a seeded draw weighted toward the centre).
Tokens are BOS, each atom's dictionary index ([UNK] for a symbol the
dictionary lacks) and EOS; the coordinates are centred on the kept atoms,
with zero BOS and EOS rows, as the ligand's are (chem/conformer.py
coords2unimol).  The targets are distances in the pose's own frame: the
ligand's holo atoms against the kept pocket atoms, and among the holo
atoms, each matrix with zero BOS and EOS rows and columns, as the
published model's targets are.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from mmdti_tpu_torch.chem.dictionary import Dictionary

POCKET_DICT = os.path.join(os.path.dirname(__file__), "pocket.dict.txt")
MAX_POCKET_ATOMS = 256


def pocket_dictionary(path: Optional[str] = None) -> Dictionary:
    """The pocket dictionary (``path``, else the packaged one) with [MASK]."""
    d = Dictionary.load(path or POCKET_DICT)
    d.add_symbol("[MASK]", is_special=True)
    return d


def crop_pocket(atoms: Sequence[str], coords, max_atoms: int = MAX_POCKET_ATOMS):
    """(atoms, coords [n, 3] float32): the ``max_atoms`` atoms nearest the
    centre, in their order, or all of them."""
    atoms = np.asarray(atoms)
    coords = np.asarray(coords, np.float32).reshape(-1, 3)
    if len(atoms) != len(coords):
        raise ValueError(f"pocket: {len(atoms)} atoms and {len(coords)} coordinates")
    if len(atoms) > max_atoms:
        d = np.linalg.norm(coords - coords.mean(axis=0), axis=1)
        keep = np.sort(np.argsort(d, kind="stable")[:max_atoms])
        atoms, coords = atoms[keep], coords[keep]
    return atoms, coords


def pocket_features(atoms: Sequence[str], coords, dictionary: Dictionary,
                    max_atoms: int = MAX_POCKET_ATOMS) -> Dict[str, np.ndarray]:
    """pocket_src_tokens [n+2] int64, pocket_src_coord [n+2, 3] float32 and
    the cropped, uncentred pocket_coord [n, 3] (the targets' frame)."""
    atoms, coords = crop_pocket(atoms, coords, max_atoms)
    tokens = np.array([dictionary.bos()] + [dictionary.index(str(a)) for a in atoms]
                      + [dictionary.eos()], np.int64)
    zero = np.zeros((1, 3), np.float32)
    centred = np.concatenate([zero, coords - coords.mean(axis=0), zero]).astype(np.float32)
    return {"pocket_src_tokens": tokens, "pocket_src_coord": centred, "pocket_coord": coords}


def docking_targets(holo_coord, pocket_coord) -> Dict[str, np.ndarray]:
    """cross_target [n+2, p+2] and holo_target [n+2, n+2] float32 of a holo
    ligand pose [n, 3] and the kept pocket atoms [p, 3], zero on the BOS
    and EOS rows and columns."""
    h = np.asarray(holo_coord, np.float64).reshape(-1, 3)
    p = np.asarray(pocket_coord, np.float64).reshape(-1, 3)
    n, m = len(h), len(p)
    cross = np.zeros((n + 2, m + 2), np.float32)
    cross[1:n + 1, 1:m + 1] = np.linalg.norm(h[:, None] - p[None], axis=-1)
    holo = np.zeros((n + 2, n + 2), np.float32)
    holo[1:n + 1, 1:n + 1] = np.linalg.norm(h[:, None] - h[None], axis=-1)
    return {"cross_target": cross, "holo_target": holo}
