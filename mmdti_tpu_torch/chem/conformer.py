"""Host-side conformer generation and Uni-Mol-style featurization.

Port of mmdti_tpu.chem.conformer, host provider only: the built-in
deterministic force-field refinement (bond springs, 1-3 angle distances,
nonbonded repulsion) over the parsed molecular graph in numpy, then
``coords2unimol`` (BOS/EOS-wrapped atom tokens, mean-centered coordinates,
full pairwise distance matrix, edge types ``tok_i * V + tok_j``,
max_atoms=256 random crop).  No RDKit, no native C++ library and no device
refinement: the numbers equal the JAX package's numpy path.
"""

from __future__ import annotations

import concurrent.futures as _fut
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmdti_tpu_torch.chem.dictionary import Dictionary
from mmdti_tpu_torch.chem.smiles import Molecule, SmilesError, parse_smiles

logger = logging.getLogger("mmdti_tpu_torch")

# single-bond covalent radii (Angstrom)
_COV_RADII: Dict[str, float] = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Br": 1.20, "I": 1.39,
    "Na": 1.66, "K": 2.03, "Li": 1.28, "Mg": 1.41, "Ca": 1.76, "Al": 1.21,
    "Fe": 1.32, "Zn": 1.22, "Cu": 1.32, "Mn": 1.39, "Se": 1.20, "As": 1.19,
    "Sn": 1.39, "Hg": 1.32, "Au": 1.36, "Pt": 1.36, "Cr": 1.39, "*": 0.76,
}
_DEFAULT_RADIUS = 1.2
_ORDER_SCALE = {1.0: 1.0, 1.5: 0.93, 2.0: 0.87, 3.0: 0.78, 4.0: 0.78}


def _ideal_bond_length(s1: str, s2: str, order: float) -> float:
    r = _COV_RADII.get(s1, _DEFAULT_RADIUS) + _COV_RADII.get(s2, _DEFAULT_RADIUS)
    return r * _ORDER_SCALE.get(order, 1.0)


def _bond_angle_terms(mol: Molecule):
    """Bond + 1-3 angle-distance spring terms (shared by the host refiners,
    which add the O(n^2) nonbonded enumeration via _build_terms, and the
    device refiner, which masks nonbonded pairs on the accelerator and
    needs no pair list — ops/device_refine.py).

    Returns (bidx [NB,2] int32, blen [NB] f32, aidx [NA,2] int32,
    alen [NA] f32, seen13 set of sorted pairs)."""
    n = mol.num_atoms()
    syms = [a.symbol for a in mol.atoms]

    bidx, blen = [], []
    order_of = {}
    for b in mol.bonds:
        bidx.append((b.a1, b.a2))
        blen.append(_ideal_bond_length(syms[b.a1], syms[b.a2], b.order))
        order_of[(b.a1, b.a2)] = b.order
        order_of[(b.a2, b.a1)] = b.order

    # 1-3 terms via every center atom
    aidx, alen = [], []
    seen13 = set()
    for j in range(n):
        nb = mol.neighbors(j)
        if len(nb) < 2:
            continue
        center = mol.atoms[j]
        max_order = max(order_of[(j, k)] for k in nb)
        if max_order >= 3.0 or (len(nb) == 2 and max_order >= 2.0 and all(order_of[(j, k)] >= 2.0 for k in nb)):
            theta = np.pi  # sp: linear
        elif center.aromatic or max_order >= 2.0 or (center.symbol in ("B",)):
            theta = np.deg2rad(120.0)
        else:
            theta = np.deg2rad(109.47)
        cos_t = np.cos(theta)
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                i, k = nb[x], nb[y]
                key = (min(i, k), max(i, k))
                if key in seen13:
                    continue
                seen13.add(key)
                d1 = _ideal_bond_length(syms[i], syms[j], order_of[(i, j)])
                d2 = _ideal_bond_length(syms[k], syms[j], order_of[(k, j)])
                d13 = np.sqrt(max(d1 * d1 + d2 * d2 - 2 * d1 * d2 * cos_t, 1e-6))
                aidx.append((i, k))
                alen.append(d13)

    return (
        np.array(bidx, dtype=np.int32).reshape(-1, 2),
        np.array(blen, dtype=np.float32),
        np.array(aidx, dtype=np.int32).reshape(-1, 2),
        np.array(alen, dtype=np.float32),
        seen13,
    )


def _build_terms(mol: Molecule):
    """Precompute (bond, angle-13, nonbonded) index/target arrays."""
    n = mol.num_atoms()
    bidx, blen, aidx, alen, seen13 = _bond_angle_terms(mol)

    # nonbonded: all pairs at graph distance >= 3 (plus cross-fragment pairs)
    bonded = {tuple(sorted(p)) for p in bidx.tolist()} | set(seen13)
    nidx = []
    for i in range(n):
        for k in range(i + 1, n):
            if (i, k) not in bonded:
                nidx.append((i, k))

    return (
        bidx, blen, aidx, alen,
        np.array(nidx, dtype=np.int32).reshape(-1, 2),
    )


def _refine(coords: np.ndarray, terms, iters: int = 300) -> np.ndarray:
    """Gradient descent with momentum on the spring/repulsion energy."""
    bidx, blen, aidx, alen, nidx = terms
    x = coords.astype(np.float64)
    vel = np.zeros_like(x)
    n = len(x)
    nb_floor = 2.2  # soft lower bound for nonbonded pairs (Angstrom)
    lr0 = 0.05
    for it in range(iters):
        lr = lr0 * (1.0 - 0.9 * it / iters)
        grad = np.zeros_like(x)
        if len(bidx):
            d = x[bidx[:, 0]] - x[bidx[:, 1]]
            dist = np.linalg.norm(d, axis=1) + 1e-9
            f = (2.0 * (dist - blen) / dist)[:, None] * d  # k=1
            np.add.at(grad, bidx[:, 0], f)
            np.add.at(grad, bidx[:, 1], -f)
        if len(aidx):
            d = x[aidx[:, 0]] - x[aidx[:, 1]]
            dist = np.linalg.norm(d, axis=1) + 1e-9
            f = (0.6 * 2.0 * (dist - alen) / dist)[:, None] * d
            np.add.at(grad, aidx[:, 0], f)
            np.add.at(grad, aidx[:, 1], -f)
        if len(nidx):
            d = x[nidx[:, 0]] - x[nidx[:, 1]]
            dist = np.linalg.norm(d, axis=1) + 1e-9
            pen = np.maximum(nb_floor - dist, 0.0)
            f = (-0.3 * 2.0 * pen / dist)[:, None] * d
            np.add.at(grad, nidx[:, 0], f)
            np.add.at(grad, nidx[:, 1], -f)
        vel = 0.8 * vel - lr * grad
        x = x + vel
        if n > 1:
            x -= x.mean(axis=0, keepdims=True)
    return x.astype(np.float32)


def _strip_hs(atoms: Sequence[str], coords: np.ndarray):
    """Drop hydrogen rows (single definition for every provider's
    remove_hs path)."""
    idx = [i for i, a in enumerate(atoms) if a != "H"]
    return [atoms[i] for i in idx], coords[idx]


def builtin_smi2coords(
    smi: str, seed: int = 42, remove_hs: bool = False
) -> Tuple[List[str], np.ndarray]:
    """Built-in provider: parse -> add explicit H -> embed -> refine."""
    mol = parse_smiles(smi).add_hydrogens()
    n = mol.num_atoms()
    atoms = [a.symbol for a in mol.atoms]
    rng = np.random.RandomState(seed if seed >= 0 else None)
    scale = max(1.5, 0.8 * n ** (1.0 / 3.0) * 2.0)
    coords = rng.randn(n, 3).astype(np.float32) * scale
    coords = _refine(coords, _build_terms(mol))
    if remove_hs:
        return _strip_hs(atoms, coords)
    return atoms, coords


def smi2coords(smi: str, seed: int = 42, remove_hs: bool = False):
    try:
        return builtin_smi2coords(smi, seed=seed, remove_hs=remove_hs)
    except SmilesError:
        raise
    except Exception:
        # zeros fallback mirrors the reference ladder's last rung
        mol = parse_smiles(smi).add_hydrogens()
        atoms = [a.symbol for a in mol.atoms]
        coords = np.zeros((len(atoms), 3), dtype=np.float32)
        if remove_hs:
            return _strip_hs(atoms, coords)
        return atoms, coords


def inner_coords(atoms: Sequence[str], coordinates, remove_hs: bool = True):
    """Optionally strip hydrogens (reference: data/conformer.py:156-180)."""
    assert len(atoms) == len(coordinates), "atom/coordinate count mismatch"
    coordinates = np.array(coordinates, dtype=np.float32)
    if remove_hs:
        return _strip_hs(list(atoms), coordinates)
    return list(atoms), coordinates


def coords2unimol(
    atoms: Sequence[str],
    coordinates,
    dictionary: Dictionary,
    max_atoms: int = 256,
    remove_hs: bool = False,
    crop_rng: Optional[np.random.RandomState] = None,
    crop_seed: Optional[int] = None,
    **_,
) -> Dict[str, np.ndarray]:
    """Tokens / centered coords / distance matrix / edge types
    (reference numerics: data/conformer.py:182-219).

    ``crop_seed`` defers RandomState construction to the (rare) crop branch —
    same draws as passing ``crop_rng=np.random.RandomState(crop_seed)``."""
    atoms, coordinates = inner_coords(atoms, coordinates, remove_hs=remove_hs)
    atoms = np.array(atoms)
    coordinates = np.array(coordinates, dtype=np.float32)
    if len(atoms) > max_atoms:
        if crop_rng is None and crop_seed is not None:
            crop_rng = np.random.RandomState(crop_seed)
        rng = crop_rng if crop_rng is not None else np.random
        idx = rng.choice(len(atoms), max_atoms, replace=False)
        atoms = atoms[idx]
        coordinates = coordinates[idx]
    src_tokens = np.array(
        [dictionary.bos()] + [dictionary.index(a) for a in atoms] + [dictionary.eos()]
    )
    src_coord = coordinates - coordinates.mean(axis=0)
    src_coord = np.concatenate(
        [np.zeros((1, 3), dtype=np.float32), src_coord, np.zeros((1, 3), dtype=np.float32)],
        axis=0,
    )
    diff = src_coord[:, None, :] - src_coord[None, :, :]
    src_distance = np.sqrt((diff * diff).sum(-1))
    vocab = len(dictionary)
    src_edge_type = src_tokens.reshape(-1, 1) * vocab + src_tokens.reshape(1, -1)
    return {
        "src_tokens": src_tokens.astype(np.int64),
        "src_distance": src_distance.astype(np.float32, copy=False),
        "src_coord": src_coord.astype(np.float32),
        "src_edge_type": src_edge_type.astype(np.int64),
    }


class ConformerGen:
    """SMILES list -> list of featurized molecule dicts (host provider).

    ``transform(smiles_list)`` and ``transform_raw(atoms_list, coords_list)``
    as in mmdti_tpu.chem.conformer.ConformerGen; ``coord_provider`` accepts
    only 'host'.  Parallelism uses a thread pool sized by ``num_workers``.
    """

    def __init__(self, **params):
        self.seed = params.get("seed", 42)
        self.max_atoms = params.get("max_atoms", 256)
        self.remove_hs = params.get("remove_hs", False)
        self.num_workers = params.get("num_workers", 0) or 0
        self.coord_provider = params.get("coord_provider", "host")
        if self.coord_provider != "host":
            raise ValueError(
                f"coord_provider must be 'host' in mmdti_tpu_torch, got "
                f"{self.coord_provider!r}"
            )
        dict_path = params.get("dict_path", None)
        unimol_dir = params.get("unimol_dir", "") or ""
        if dict_path is None and unimol_dir:
            cand = os.path.join(os.path.dirname(unimol_dir), "mol.dict.txt")
            dict_path = cand if os.path.exists(cand) else None
        self.dictionary = Dictionary.load(dict_path)
        self.dictionary.add_symbol("[MASK]", is_special=True)
        logger.info(
            "ConformerGen initialized: seed=%s max_atoms=%s remove_hs=%s",
            self.seed, self.max_atoms, self.remove_hs,
        )

    def single_process(self, smiles: str) -> Dict[str, np.ndarray]:
        atoms, coordinates = smi2coords(
            smiles, seed=self.seed, remove_hs=self.remove_hs
        )
        return coords2unimol(
            atoms, coordinates, self.dictionary, self.max_atoms, remove_hs=self.remove_hs,
            crop_seed=self.seed,
        )

    def transform_raw(self, atoms_list, coordinates_list):
        return [
            coords2unimol(a, c, self.dictionary, self.max_atoms, remove_hs=self.remove_hs)
            for a, c in zip(atoms_list, coordinates_list)
        ]

    def transform(self, smiles_list: Sequence[str]):
        logger.info("Start generating conformers for %d molecules...", len(smiles_list))
        if self.num_workers and self.num_workers > 1:
            with _fut.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                inputs = list(pool.map(self.single_process, smiles_list))
        else:
            inputs = [self.single_process(s) for s in smiles_list]
        return self._log_failures(inputs)

    @staticmethod
    def _log_failures(inputs):
        if inputs:
            failed = float(np.mean([(item["src_coord"] == 0.0).all() for item in inputs]))
            failed_3d = float(np.mean([(item["src_coord"][:, 2] == 0.0).all() for item in inputs]))
            logger.info("Failed to generate conformers for %.2f%% of molecules.", failed * 100)
            logger.info("Failed to generate 3d conformers for %.2f%% of molecules.", failed_3d * 100)
        return inputs
