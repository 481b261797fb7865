"""Bemis-Murcko scaffold grouping keys (port of mmdti_tpu/chem/scaffold.py,
its built-in branch: the port never uses RDKit).

The scaffold graph is the ring systems plus linker atoms (acyclic terminal
atoms pruned until none is left) plus atoms multiple-bonded to that core;
the key is a canonical Weisfeiler-Lehman hash of that graph, the same key
the JAX package computes when RDKit is absent.  Scaffolds are only used as
grouping keys (scaffold splits, group columns).
"""

from __future__ import annotations

import hashlib
import logging
from typing import Set

from mmdti_tpu_torch.chem.smiles import Molecule, SmilesError, parse_smiles

logger = logging.getLogger("mmdti_tpu_torch")

_WARNED_CHIRALITY = False


def _murcko_atom_set(mol: Molecule) -> Set[int]:
    ring_atoms = {i for i, a in enumerate(mol.atoms) if a.in_ring}
    if not ring_atoms:
        return set()
    keep = set(range(mol.num_atoms()))
    # iteratively prune terminal atoms that are not in rings -> rings + linkers
    changed = True
    while changed:
        changed = False
        for i in list(keep):
            if i in ring_atoms:
                continue
            deg = sum(1 for j in mol.neighbors(i) if j in keep)
            if deg <= 1:
                keep.discard(i)
                changed = True
    # re-attach atoms multiple-bonded to the core (e.g. exocyclic =O)
    extra = set()
    for b in mol.bonds:
        if b.order >= 2.0 and not b.aromatic:
            if b.a1 in keep and b.a2 not in keep:
                extra.add(b.a2)
            elif b.a2 in keep and b.a1 not in keep:
                extra.add(b.a1)
    return keep | extra


def _wl_canonical_key(mol: Molecule, atom_set: Set[int], include_chirality: bool = True) -> str:
    """Canonical Weisfeiler-Lehman refinement hash of the induced subgraph.

    include_chirality is accepted for API symmetry but has no effect here:
    the built-in parser does not retain @/@@ marks, so enantiomeric
    scaffolds share one key (warned once in murcko_scaffold)."""
    if not atom_set:
        return ""
    idxs = sorted(atom_set)
    pos = {a: k for k, a in enumerate(idxs)}
    labels = []
    for a in idxs:
        at = mol.atoms[a]
        labels.append(f"{at.symbol}|{int(at.aromatic)}|{at.charge}")
    adj = [[] for _ in idxs]
    for b in mol.bonds:
        if b.a1 in atom_set and b.a2 in atom_set:
            lbl = "ar" if b.aromatic else str(b.order)
            adj[pos[b.a1]].append((pos[b.a2], lbl))
            adj[pos[b.a2]].append((pos[b.a1], lbl))
    cur = labels
    for _ in range(max(3, len(idxs).bit_length() + 1)):
        nxt = []
        for v in range(len(idxs)):
            neigh = sorted(f"{lbl}:{cur[u]}" for u, lbl in adj[v])
            nxt.append(hashlib.sha1((cur[v] + "|" + ";".join(neigh)).encode()).hexdigest()[:16])
        cur = nxt
    digest = hashlib.sha1("|".join(sorted(cur)).encode()).hexdigest()
    return f"scaffold:{digest}"


def murcko_scaffold(smiles: str, include_chirality: bool = True) -> str:
    """Scaffold grouping key for a SMILES string: the canonical WL key of
    its scaffold graph ('' for an acyclic molecule), or the input SMILES
    when it does not parse.  Chirality-blind: stereo marks are not kept."""
    global _WARNED_CHIRALITY
    try:
        if include_chirality and not _WARNED_CHIRALITY and ("@" in smiles):
            _WARNED_CHIRALITY = True
            logger.warning(
                "Scaffold keys are chirality-blind: enantiomeric scaffolds "
                "share one split group."
            )
        mol = parse_smiles(smiles)
        return _wl_canonical_key(mol, _murcko_atom_set(mol), include_chirality)
    except SmilesError:
        return smiles
    except Exception:
        return smiles
