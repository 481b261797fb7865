"""Device conformer provider, host side (port of
mmdti_tpu/chem/device_conformer.py).

Parses SMILES and builds the spring-term arrays on the host (the native
library: chem/native.py), then refines whole groups of molecules on the
device in one call each (ops/device_refine.py: one CUDA graph replay a
group on the card).

Determinism: a molecule's refined coordinates depend only on its own
SMILES and the seed, up to float accumulation order.  Every padded shape
is a function of the molecule's own atom bucket (bonds capped at 2 x Np,
angle terms at 4 x Np), molecules are grouped by bucket (at most
GROUP_MAX a group), and the
incidence products are batched GEMMs, so co-batched molecules never enter
a molecule's sums; the molecule count can still change the GEMM's
algorithm, which drifts a coordinate by about 1e-6 A over 300 iterations
(tests hold it under 1e-5).  Repeat calls of one group are bit-equal, and
a server's feature cache pins a SMILES to its first coordinates.

Routing, per molecule: a SmilesError propagates; any other preparation
failure gives zero coordinates; molecules under ``min_atoms`` atoms, and
molecules whose term counts pass the caps, take the host ladder
(conformer.builtin_smi2coords).  A device failure raises: unlike the JAX
package, no group falls back to the host, which would hide the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmdti_tpu_torch.chem import native
from mmdti_tpu_torch.chem.smiles import SmilesError, parse_smiles

# caps as multiples of the atom bucket (see the determinism note above)
_NB_FACTOR = 2
_NA_FACTOR = 4
# molecules a group at most: a bucket's molecules refine in groups of up to
# 64, so a group's molecule count pads to 8, 16, 32 or 64 and the recorded
# graphs and their memory stay bounded however many molecules a fit has
GROUP_MAX = 64


def _atom_bucket(n: int) -> int:
    """Atom-count buckets: powers of two from 16 up to 128, then 64-steps."""
    b = 16
    while b < n and b < 128:
        b *= 2
    if b >= n:
        return b
    return -(-n // 64) * 64


def _prepare(smi: str, seed: int):
    """Parse, terms and the seeded initial coordinates, on the host:
    (atoms, coords0, bond idx, bond len, angle idx, angle len).

    The native parse (hydrogens expanded) and angle-term builder, bit-exact
    with the Python builders; only the per-bond ideal length and the
    initial draw run in Python.  Where the native parse declines, the
    Python parser runs (and raises the detailed SmilesError); where the
    native term builder declines, the Python one."""
    from mmdti_tpu_torch.chem.conformer import (
        _bond_angle_terms,
        _ideal_bond_length,
        _initial_coords,
    )

    parsed = native.parse_graph(smi)
    if parsed is not None:
        atoms, flags, bidx, orders = parsed
        n = len(atoms)
        blens = np.array(
            [_ideal_bond_length(atoms[i], atoms[j], o)
             for (i, j), o in zip(bidx.tolist(), orders.tolist())],
            dtype=np.float64,
        )
        out = native.angle_terms_from_arrays(n, bidx, orders, blens, flags)
        if out is not None:
            aidx, alen = out
            return (atoms, _initial_coords(n, seed), bidx, blens.astype(np.float32),
                    aidx, alen)

    mol = parse_smiles(smi).add_hydrogens()
    atoms = [a.symbol for a in mol.atoms]
    coords0 = _initial_coords(mol.num_atoms(), seed)
    terms = native.bond_angle_terms(mol)
    if terms is None:
        bidx, blen, aidx, alen, _ = _bond_angle_terms(mol)
    else:
        bidx, blen, aidx, alen = terms
    return atoms, coords0, bidx, blen, aidx, alen


class DeviceConformerBatcher:
    """Groups prepared molecules by atom bucket and refines each group in
    one call on ``device`` (None: CUDA where it is available)."""

    def __init__(self, iters: int = 300, device=None, capture_gate=None):
        import torch

        self.iters = int(iters)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.capture_gate = capture_gate

    def group_arrays(self, bucket: int, items) -> Tuple[np.ndarray, ...]:
        """One bucket's prepared molecules as padded host arrays: the
        molecule count padded by pad_counts (zero rows have no atoms and
        only (0, 0) springs: force-free), int16 term indices (Np <= 512)."""
        from mmdti_tpu_torch.ops.device_refine import pad_counts

        m = pad_counts(len(items))
        nb_cap, na_cap = bucket * _NB_FACTOR, bucket * _NA_FACTOR
        coords0 = np.zeros((m, bucket, 3), np.float32)
        n_atoms = np.zeros((m,), np.int32)
        b_idx = np.zeros((m, nb_cap, 2), np.int16)
        b_len = np.zeros((m, nb_cap), np.float32)
        a_idx = np.zeros((m, na_cap, 2), np.int16)
        a_len = np.zeros((m, na_cap), np.float32)
        for r, (_, (atoms, c0, bi, bl, ai, al)) in enumerate(items):
            n = len(atoms)
            coords0[r, :n] = c0
            n_atoms[r] = n
            b_idx[r, :len(bl)] = bi
            b_len[r, :len(bl)] = bl
            a_idx[r, :len(al)] = ai
            a_len[r, :len(al)] = al
        return coords0, n_atoms, b_idx, b_len, a_idx, a_len

    def refine_groups(
        self, prepared: Dict[int, List[Tuple[int, tuple]]]
    ) -> Dict[int, np.ndarray]:
        """prepared: bucket -> [(original index, _prepare's tuple)].
        Returns original index -> refined [n, 3] float32 coordinates.  Each
        bucket refines in groups of at most GROUP_MAX molecules.  On the
        card every copy and replay runs on the refinement stream
        (ops/device_refine.py ``refine_stream``), and so does the pull: it
        waits for the refinement alone, not for work queued on other
        streams (a server's forward in flight).  The int16 indices cross to
        the device as they are and widen there."""
        import torch

        from mmdti_tpu_torch.ops.device_refine import refine_conformers, refine_stream

        groups = [(bucket, items[i:i + GROUP_MAX])
                  for bucket, items in sorted(prepared.items())
                  for i in range(0, len(items), GROUP_MAX)]
        on_card = self.device.type == "cuda"
        with torch.cuda.stream(refine_stream(self.device)) if on_card \
                else contextlib.nullcontext():
            refined = []
            for bucket, items in groups:
                arrays = self.group_arrays(bucket, items)
                tensors = [torch.from_numpy(a).to(self.device) for a in arrays]
                refined.append(refine_conformers(*tensors, iters=self.iters,
                                                 capture_gate=self.capture_gate))
            refined = [r.cpu().numpy() for r in refined]
        out: Dict[int, np.ndarray] = {}
        for (_, items), coords in zip(groups, refined):
            for r, (orig_i, (atoms, *_)) in enumerate(items):
                out[orig_i] = coords[r, : len(atoms)]
        return out


def device_smi2coords_batch(
    smiles_list: Sequence[str],
    seed: int = 42,
    remove_hs: bool = False,
    iters: int = 300,
    min_atoms: int = 48,
    device=None,
    capture_gate=None,
) -> List[Tuple[List[str], np.ndarray]]:
    """(atoms, coordinates) of each SMILES, in order, refined on ``device``.

    ``min_atoms``: molecules with fewer atoms (hydrogens included) refine
    on the host, a rule on each molecule's own atom count, so the routing
    does not depend on what else is in the list; it is part of the
    conformer-cache fingerprint (data/hub.py)."""
    from mmdti_tpu_torch.chem.conformer import _strip_hs, builtin_smi2coords

    native.available()   # a library that does not build raises, not zeros
    prepared: Dict[int, List[Tuple[int, tuple]]] = {}
    results: List[Optional[Tuple[List[str], np.ndarray]]] = [None] * len(smiles_list)
    host: List[int] = []
    for i, smi in enumerate(smiles_list):
        try:
            item = _prepare(smi, seed)
        except SmilesError:
            raise
        except Exception:
            mol = parse_smiles(smi).add_hydrogens()
            atoms = [a.symbol for a in mol.atoms]
            results[i] = (atoms, np.zeros((len(atoms), 3), np.float32))
            continue
        atoms, _, _, bl, _, al = item
        bucket = _atom_bucket(len(atoms))
        if len(atoms) < min_atoms:
            host.append(i)   # small molecule: the host ladder
            continue
        if len(bl) > bucket * _NB_FACTOR or len(al) > bucket * _NA_FACTOR:
            host.append(i)   # past the term caps: the host ladder
            continue
        prepared.setdefault(bucket, []).append((i, item))

    for i in host:
        results[i] = builtin_smi2coords(smiles_list[i], seed=seed, remove_hs=False)

    if prepared:
        refined = DeviceConformerBatcher(iters=iters, device=device,
                                         capture_gate=capture_gate).refine_groups(prepared)
        for bucket_items in prepared.values():
            for orig_i, (atoms, *_) in bucket_items:
                results[orig_i] = (atoms, refined[orig_i])

    final: List[Tuple[List[str], np.ndarray]] = []
    for atoms, coords in results:
        if remove_hs:
            atoms, coords = _strip_hs(atoms, coords)
        final.append((list(atoms), coords))
    return final
