"""MOF (metal-organic framework) data reading (port of mmdti_tpu/chem/mof.py).

CIF crystal parsing, the gas-id and gas-attribute tables, and the MOF
featurizer (the distance matrix leaves out the BOS and EOS rows).  The JAX
package parses CIFs with pymatgen where it is importable and with its
built-in reader otherwise; the port has the built-in reader only (cell
parameters and the first atom_site loop, fractional or cartesian
coordinates), and its features equal the JAX built-in reader's.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmdti_tpu_torch.chem.dictionary import Dictionary

GAS_LIST = ["CH4", "CO2", "Ar", "Kr", "Xe", "O2", "He", "N2", "H2"]

GAS2ID = {
    "UNK": 0, "CH4": 1, "CO2": 2, "Ar": 3, "Kr": 4, "Xe": 5,
    "O2": 6, "He": 7, "N2": 8, "H2": 9,
}

# standardized physical attribute vectors per gas (the reference's table)
GAS2ATTR = {
    "CH4": [0.295589, 0.165132, 0.251511019, -0.61518, 0.026952, 0.25887781],
    "CO2": [1.475242, 1.475921, 1.620478155, 0.086439, 1.976795, 1.69928074],
    "Ar": [-0.11632, 0.294448, 0.1914686, -0.01667, -0.07999, -0.1631478],
    "Kr": [0.48802, 0.602454, 0.215485568, 1.084671, 0.415991, 0.39885917],
    "Xe": [1.324657, 0.751519, 0.233498293, 2.276323, 1.12122, 1.18462811],
    "O2": [-0.08095, 0.37909, 0.335570404, -0.61626, -0.5363, -0.1130181],
    "He": [-1.66617, -1.88746, -2.15618995, -0.9173, -1.36413, -1.6042445],
    "N2": [-0.37636, -0.3968, 0.41962979, -0.31495, -0.40022, -0.3355659],
    "H2": [-1.34371, -1.3843, -1.11145188, -0.96708, -1.16031, -1.3256695],
}


def _lattice_matrix(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Lattice vectors (rows) from the cell parameters."""
    al, be, ga = np.deg2rad([alpha, beta, gamma])
    v1 = np.array([a, 0.0, 0.0])
    v2 = np.array([b * np.cos(ga), b * np.sin(ga), 0.0])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / max(np.sin(ga), 1e-12)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return np.stack([v1, v2, np.array([cx, cy, cz])])


def _cif_number(tok: str) -> float:
    # strip an uncertainty in parentheses: 1.234(5) -> 1.234
    return float(re.sub(r"\(.*\)", "", tok))


def _atom_site_loop(lines: List[str], path: str):
    """(symbols, fractional rows, cartesian rows) of the first atom_site
    loop that holds atoms."""
    atoms: List[str] = []
    frac: List[List[float]] = []
    cart: List[List[float]] = []
    i = 0
    while i < len(lines):
        if not lines[i].startswith("loop_"):
            i += 1
            continue
        headers = []
        j = i + 1
        while j < len(lines) and lines[j].startswith("_"):
            headers.append(lines[j].split()[0])
            j += 1
        if any(h.startswith("_atom_site") for h in headers):
            cols = {h: idx for idx, h in enumerate(headers)}
            sym_col = cols.get("_atom_site_type_symbol", cols.get("_atom_site_label"))
            if sym_col is None:
                raise ValueError(f"CIF atom_site loop has neither type_symbol nor label: {path}")
            # x/y/z by header: CIF does not require the columns to be adjacent
            fcols = [cols.get(f"_atom_site_fract_{ax}") for ax in "xyz"]
            ccols = [cols.get(f"_atom_site_Cartn_{ax}") for ax in "xyz"]
            have_frac = all(c is not None for c in fcols)
            have_cart = all(c is not None for c in ccols)
            if not have_frac and not have_cart:
                raise ValueError(
                    f"CIF atom_site loop has no complete fract_/Cartn_ xyz columns: {path}")
            while j < len(lines) and lines[j] and not lines[j].startswith(
                    ("loop_", "_", "#", "data_")):
                toks = lines[j].split()
                if len(toks) >= len(headers):
                    atoms.append(re.sub(r"[\d+\-']+.*$", "", toks[sym_col]))
                    if have_frac:
                        frac.append([_cif_number(toks[c]) for c in fcols])
                    else:
                        cart.append([_cif_number(toks[c]) for c in ccols])
                j += 1
            if atoms:
                break
        i = j
    return atoms, frac, cart


def parse_cif(path: str) -> Dict:
    """Minimal CIF parser: cell parameters and the first atom_site loop."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = [line.strip() for line in f]
    cell = {}
    for line in lines:
        m = re.match(r"_cell_(length|angle)_(\w+)\s+(\S+)", line)
        if m:
            cell[f"{m.group(1)}_{m.group(2)}"] = _cif_number(m.group(3))
    atoms, frac, cart = _atom_site_loop(lines, path)
    if not atoms:
        raise ValueError(f"no atom sites found in CIF {path}")
    abc = (cell.get("length_a", 1.0), cell.get("length_b", 1.0), cell.get("length_c", 1.0))
    angles = (cell.get("angle_alpha", 90.0), cell.get("angle_beta", 90.0),
              cell.get("angle_gamma", 90.0))
    lattice = _lattice_matrix(*abc, *angles)
    if frac:
        coords = np.asarray(frac, dtype=np.float64) @ lattice
        abc_coords = np.asarray(frac, dtype=np.float32)
    else:
        coords = np.asarray(cart, dtype=np.float64)
        abc_coords = (coords @ np.linalg.inv(lattice)).astype(np.float32)
    name = os.path.basename(path)
    return {
        "ID": name[:-4] if name.endswith(".cif") else name,
        "atoms": atoms,
        "coordinates": coords.astype(np.float32),
        "abc": abc,
        "angles": angles,
        "volume": float(abs(np.linalg.det(lattice))),
        "lattice_matrix": lattice,
        "abc_coordinates": abc_coords,
    }


def coords2unimol_mof(
    atoms: Sequence[str],
    coordinates,
    dictionary: Dictionary,
    max_atoms: int = 512,
    crop_rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """MOF featurizer: tokens with BOS and EOS, centred coordinates with
    zero BOS and EOS rows, distances among the crystal atoms only (the BOS
    and EOS rows and columns stay 0) and edge types over all tokens.  A
    crystal of more than ``max_atoms`` atoms keeps a random ``max_atoms``
    of them, drawn from ``crop_rng``."""
    atoms = np.array(atoms)
    coordinates = np.array(coordinates, dtype=np.float32)
    if len(atoms) > max_atoms:
        rng = crop_rng if crop_rng is not None else np.random
        idx = rng.choice(len(atoms), max_atoms, replace=False)
        atoms = atoms[idx]
        coordinates = coordinates[idx]
    src_tokens = np.array(
        [dictionary.bos()] + [dictionary.index(a) for a in atoms] + [dictionary.eos()]
    )
    src_coord = coordinates - coordinates.mean(axis=0)
    src_coord = np.concatenate(
        [np.zeros((1, 3), np.float32), src_coord, np.zeros((1, 3), np.float32)], axis=0
    )
    n = len(src_tokens)
    src_distance = np.zeros((n, n), dtype=np.float32)
    inner = src_coord[1:-1]
    diff = inner[:, None, :] - inner[None, :, :]
    src_distance[1:-1, 1:-1] = np.sqrt((diff * diff).sum(-1))
    vocab = len(dictionary)
    src_edge_type = src_tokens.reshape(-1, 1) * vocab + src_tokens.reshape(1, -1)
    return {
        "src_tokens": src_tokens.astype(np.int64),
        "src_distance": src_distance,
        "src_coord": src_coord.astype(np.float32),
        "src_edge_type": src_edge_type.astype(np.int64),
    }


class MOFReader:
    """CIF + gas -> featurized MOF sample."""

    def __init__(self, dict_path: Optional[str] = None, max_atoms: int = 512,
                 seed: int = 42):
        self.gas_list = list(GAS_LIST)
        self.dictionary = Dictionary.load(dict_path)
        self.dictionary.add_symbol("[MASK]", is_special=True)
        self.max_atoms = max_atoms
        # the crop of a crystal past max_atoms is seeded from its content
        # and this seed, so a CIF featurizes the same at any dataset
        # position (the conformer cache and resume rely on it)
        self.crop_seed = int(seed)

    def cif_parser(self, cif_path: str) -> Dict:
        return parse_cif(cif_path)

    def gas_parser(self, gas: str = "CH4") -> Dict:
        assert gas in self.gas_list, (
            f"{gas} is not in list, current we support: {'-'.join(self.gas_list)}"
        )
        return {"gas_id": GAS2ID.get(gas, 0), "gas_attr": GAS2ATTR.get(gas, [0.0] * 6)}

    def _structure_crop_rng(self, atoms, coords) -> np.random.RandomState:
        """The crop RNG of one structure: its symbols and coordinates
        (rounded to 1e-4) hashed with crc32, mixed with the reader's seed."""
        blob = ("|".join(atoms)).encode() + np.ascontiguousarray(
            np.round(np.asarray(coords, np.float64), 4)
        ).tobytes()
        return np.random.RandomState(
            (zlib.crc32(blob) ^ (self.crop_seed & 0xFFFFFFFF)) & 0x7FFFFFFF
        )

    def read_with_gas(self, cif_path: str, gas: str) -> Dict:
        dd = self.cif_parser(cif_path)
        crop_rng = (
            self._structure_crop_rng(dd["atoms"], dd["coordinates"])
            if len(dd["atoms"]) > self.max_atoms
            else None
        )
        feat = coords2unimol_mof(
            dd["atoms"], dd["coordinates"], self.dictionary,
            max_atoms=self.max_atoms, crop_rng=crop_rng,
        )
        feat.update(self.gas_parser(gas))
        return feat
