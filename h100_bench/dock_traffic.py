"""The generator of the docking mixes' data: protein-ligand complexes made
from a mix's ``dataset`` parameters (kind ``complexes``) and the run's
seed, with the numpy streams of traffic.py.

A complex is a ligand of ``ligand_atoms`` heavy atoms (tokens BOS, the
atoms, EOS, padded to the mix's ``atom_pad``) whose holo pose is a random
walk of ``step_angstrom`` steps about the origin, an input conformer that
moves each holo atom by a length drawn from ``conformer_shift_angstrom``
in a uniform direction (then centred), and a pocket of ``pocket_atoms``
raw atoms (element symbols and coordinates, the program crops and pads
them) in a shell about the ligand: ``pocket_density`` atoms an Angstrom
cubed from ``pocket_gap_angstrom`` past the ligand's RMS radius, then
scaled about its centre so that a share drawn from ``near_share`` of the
ligand-pocket pairs that stay after the crop at ``max_pocket_atoms`` lie
under ``near_angstrom`` (the loss's distance threshold).

Every seed gets the same multiset of ligand sizes and of pocket sizes in
another order (traffic.spread_sizes), so that the seed changes which
complexes meet and not how much work a run does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from h100_bench.traffic import random_walk, rng_for, spread_sizes


def _symbols(spec: Dict[str, float], n: int, rng) -> list:
    names = list(spec)
    p = np.asarray([spec[s] for s in names], np.float64)
    return [names[i] for i in rng.choice(len(names), size=n, p=p / p.sum())]


def crop_order(coords: np.ndarray, max_atoms: int) -> np.ndarray:
    """The indices the crop keeps: the ``max_atoms`` atoms nearest the
    centre, in their order."""
    if len(coords) <= max_atoms:
        return np.arange(len(coords))
    d = np.linalg.norm(coords - coords.mean(axis=0), axis=1)
    return np.sort(np.argsort(d, kind="stable")[:max_atoms])


def near_share(ligand: np.ndarray, pocket: np.ndarray, cut: float) -> float:
    """The share of ligand-pocket pairs under ``cut`` Angstrom."""
    d = np.linalg.norm(ligand[:, None, :] - pocket[None, :, :], axis=-1)
    return float((d < cut).mean())


def _pocket(holo: np.ndarray, p: int, ds: dict, max_atoms: int, share: float, rng):
    r_in = float(np.sqrt((holo ** 2).sum(axis=1).mean())) + ds["pocket_gap_angstrom"]
    r_out = (r_in ** 3 + 3.0 * p / ds["pocket_density"] / (4.0 * np.pi)) ** (1.0 / 3.0)
    u = rng.random(p)
    radius = (r_in ** 3 + u * (r_out ** 3 - r_in ** 3)) ** (1.0 / 3.0)
    d = rng.normal(size=(p, 3))
    shell = d / np.linalg.norm(d, axis=1, keepdims=True) * radius[:, None]
    centre = shell.mean(axis=0)
    kept = shell[crop_order(shell, max_atoms)] - centre
    lo, hi = 0.25, 4.0
    for _ in range(40):
        k = 0.5 * (lo + hi)
        if near_share(holo, centre + k * kept, ds["near_angstrom"]) > share:
            lo = k
        else:
            hi = k
    k = 0.5 * (lo + hi)
    # scaling about the centre keeps the crop's choice
    return (centre + k * (shell - centre)).astype(np.float32)


def complexes(cfg: dict, mix: dict, seed: int) -> dict:
    """The complexes, ligands padded and pockets raw: src_tokens [R, Nm]
    int64, src_coord [R, Nm, 3] float32 (the input conformer), holo [R, Nm,
    3] float32 (the holo pose, zero on BOS, EOS and pads), n_atoms [R]
    (with BOS and EOS); per complex pocket_symbols and pocket_coord [p, 3]
    float32; n_pocket [R] (kept by the crop, with BOS and EOS)."""
    ds = mix["dataset"]
    R, N = ds["count"], mix["atom_pad"]
    vocab = cfg["atom_vocab"]
    pad, bos, eos = cfg["atom_pad_idx"], vocab.index("[CLS]"), vocab.index("[SEP]")
    lig = spread_sizes(R, *ds["ligand_atoms"], seed)
    pkt = spread_sizes(R, *ds["pocket_atoms"], seed + 1)
    if lig.max() + 2 > N:
        raise ValueError(f"the mix's ligands do not fit its pad N={N}")
    rng = rng_for(seed, "complexes")
    lo_share, hi_share = ds["near_share"]
    lo_shift, hi_shift = ds["conformer_shift_angstrom"]
    src_tokens = np.full((R, N), pad, np.int64)
    src_coord = np.zeros((R, N, 3), np.float32)
    holo = np.zeros((R, N, 3), np.float32)
    symbols, coords = [], []
    for r in range(R):
        n, p = int(lig[r]), int(pkt[r])
        src_tokens[r, 0], src_tokens[r, n + 1] = bos, eos
        src_tokens[r, 1:n + 1] = [vocab.index(s) for s in _symbols(ds["ligand_elements"], n, rng)]
        pose = random_walk(n, ds["step_angstrom"], rng).astype(np.float64)
        holo[r, 1:n + 1] = pose
        d = rng.normal(size=(n, 3))
        shift = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(lo_shift, hi_shift,
                                                                         (n, 1))
        moved = pose + shift
        src_coord[r, 1:n + 1] = moved - moved.mean(axis=0)
        symbols.append(_symbols(ds["pocket_elements"], p, rng))
        coords.append(_pocket(pose, p, ds, mix["max_pocket_atoms"],
                              rng.uniform(lo_share, hi_share), rng))
    return {"src_tokens": src_tokens, "src_coord": src_coord, "holo": holo,
            "n_atoms": lig + 2, "pocket_symbols": symbols, "pocket_coord": coords,
            "n_pocket": np.minimum(pkt, mix["max_pocket_atoms"]) + 2}
