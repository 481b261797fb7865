"""Self-contained SMILES parser and molecular graph.

The reference delegates all SMILES handling to RDKit
(reference data/conformer.py:114-116, reference data/datareader.py:148).
RDKit is an optional dependency here; this module provides the built-in
fallback: a SMILES reader producing an atom/bond graph with implicit-hydrogen
counts, ring perception, and validity checking.

Supported grammar (covers MoleculeNet-style drug-like SMILES):
  * organic-subset atoms  B C N O P S F Cl Br I  and aromatic  b c n o p s
  * bracket atoms  [isotope? symbol @|@@? H<n>? +|-<n>? (:map)?]  incl. *
  * bonds  - = # $ : / \\  (directional bonds parsed as single)
  * branches ( ... ), ring closures 1-9 and %nn, dot-disconnected fragments
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

# Default valences used for implicit-H calculation (first match >= bond sum).
_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

_ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}

# Recognized element symbols for bracket atoms (superset incl. metals).
ELEMENTS: Set[str] = {
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg", "Al",
    "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe",
    "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr",
    "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Sm", "Eu",
    "Gd", "Tb", "Dy", "Ho", "Er", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os",
    "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "U", "*",
}

BOND_ORDERS = {"-": 1.0, "=": 2.0, "#": 3.0, "$": 4.0, ":": 1.5, "/": 1.0, "\\": 1.0}


@dataclasses.dataclass
class Atom:
    symbol: str                 # capitalized element symbol ('*' allowed)
    aromatic: bool = False
    charge: int = 0
    explicit_h: Optional[int] = None   # from brackets; None => implicit rule
    isotope: Optional[int] = None
    in_ring: bool = False
    idx: int = -1


@dataclasses.dataclass
class Bond:
    a1: int
    a2: int
    order: float = 1.0          # 1.5 == aromatic
    aromatic: bool = False


class Molecule:
    """Light molecular graph."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, List[int]] = {}  # atom idx -> bond indices

    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self._adj[atom.idx] = []
        return atom.idx

    def add_bond(self, a1: int, a2: int, order: float = 1.0, aromatic: bool = False) -> int:
        if a1 == a2:
            raise SmilesError("self-bond")
        b = Bond(a1, a2, order, aromatic)
        bidx = len(self.bonds)
        self.bonds.append(b)
        self._adj[a1].append(bidx)
        self._adj[a2].append(bidx)
        return bidx

    def neighbors(self, i: int) -> List[int]:
        out = []
        for bidx in self._adj[i]:
            b = self.bonds[bidx]
            out.append(b.a2 if b.a1 == i else b.a1)
        return out

    def atom_bonds(self, i: int) -> List[Bond]:
        return [self.bonds[bidx] for bidx in self._adj[i]]

    def degree(self, i: int) -> int:
        return len(self._adj[i])

    def num_atoms(self) -> int:
        return len(self.atoms)

    # ----- implicit hydrogens -------------------------------------------------
    def implicit_h(self, i: int) -> int:
        a = self.atoms[i]
        if a.explicit_h is not None:
            return a.explicit_h
        sym = a.symbol
        if sym not in _VALENCES or sym == "*":
            return 0
        bond_sum = sum(b.order for b in self.atom_bonds(i))
        if a.aromatic:
            # Divalent aromatic heteroatoms (o, s, se: lowest valence 2) have
            # their valence filled by the two ring bonds — never an implicit
            # H (the 1.5-per-bond rule below would push thiophene's s to
            # "need 3" and hand it a phantom H that RDKit does not add).
            if _VALENCES[sym][0] <= 2:
                return 0
            # other lowercase aromatic atoms get H only to complete the
            # lowest standard valence
            bond_sum = max(bond_sum, 1.5 * self.degree(i))
        # NOTE: charged atoms always come from bracket notation, which sets
        # explicit_h (early return above) — no charge-valence rule is needed
        # on this path.
        need = bond_sum
        for v in _VALENCES[sym]:
            if v + 1e-9 >= need:
                return max(int(round(v - need)), 0)
        return 0

    def total_h(self, i: int) -> int:
        """Implicit + neighboring explicit-H atoms are NOT double counted:
        only implicit count here."""
        return self.implicit_h(i)

    # ----- ring perception ----------------------------------------------------
    def perceive_rings(self) -> Set[int]:
        """Mark atoms that sit on a cycle.  An edge is a ring edge iff it is
        not a bridge; computed with one DFS (Tarjan bridges)."""
        n = self.num_atoms()
        visited = [False] * n
        tin = [0] * n
        low = [0] * n
        timer = [0]
        ring_edges: Set[int] = set()

        # iterative DFS to avoid recursion limits
        for root in range(n):
            if visited[root]:
                continue
            stack = [(root, -1, iter(self._adj[root]))]
            visited[root] = True
            timer[0] += 1
            tin[root] = low[root] = timer[0]
            while stack:
                v, pedge, it = stack[-1]
                advanced = False
                for bidx in it:
                    if bidx == pedge:
                        continue
                    b = self.bonds[bidx]
                    to = b.a2 if b.a1 == v else b.a1
                    if visited[to]:
                        low[v] = min(low[v], tin[to])
                        ring_edges.add(bidx)  # back edge => on a cycle
                    else:
                        visited[to] = True
                        timer[0] += 1
                        tin[to] = low[to] = timer[0]
                        stack.append((to, bidx, iter(self._adj[to])))
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
                    if stack:
                        pv = stack[-1][0]
                        low[pv] = min(low[pv], low[v])
                        if low[v] > tin[pv]:
                            pass  # bridge
                        else:
                            ring_edges.add(pedge)

        ring_atoms: Set[int] = set()
        for bidx in ring_edges:
            b = self.bonds[bidx]
            ring_atoms.add(b.a1)
            ring_atoms.add(b.a2)
            # mark ring bonds for downstream use
        self._ring_edges = ring_edges
        for i in ring_atoms:
            self.atoms[i].in_ring = True
        return ring_atoms

    def ring_bond_indices(self) -> Set[int]:
        if not hasattr(self, "_ring_edges"):
            self.perceive_rings()
        return self._ring_edges

    # ----- explicit-H expansion -------------------------------------------
    def add_hydrogens(self) -> "Molecule":
        """Return a new molecule with implicit hydrogens made explicit
        (equivalent of RDKit AddHs used at
        reference data/conformer.py:115)."""
        m = Molecule()
        for a in self.atoms:
            m.add_atom(Atom(a.symbol, a.aromatic, a.charge, 0, a.isotope))
        for b in self.bonds:
            m.add_bond(b.a1, b.a2, b.order, b.aromatic)
        for i in range(self.num_atoms()):
            for _ in range(self.implicit_h(i)):
                h = m.add_atom(Atom("H", explicit_h=0))
                m.add_bond(i, h, 1.0)
        return m


class SmilesError(ValueError):
    pass


def _read_bracket_atom(s: str, pos: int) -> Tuple[Atom, int]:
    """Parse ``[...]`` starting at s[pos] == '['; return (atom, next_pos)."""
    j = s.find("]", pos)
    if j < 0:
        raise SmilesError("unclosed bracket atom")
    body = s[pos + 1 : j]
    k = 0
    isotope = None
    # isotope
    num = ""
    while k < len(body) and body[k].isdigit():
        num += body[k]
        k += 1
    if num:
        isotope = int(num)
    # element symbol (two-letter first), aromatic lowercase allowed
    aromatic = False
    sym = None
    if k < len(body):
        two = body[k : k + 2]
        if len(two) == 2 and two[0].isupper() and two[1].islower() and two in ELEMENTS:
            sym = two
            k += 2
        elif body[k] == "*":
            sym = "*"
            k += 1
        elif body[k].isupper():
            if body[k] not in ELEMENTS:
                raise SmilesError(f"unknown element {body[k]!r}")
            sym = body[k]
            k += 1
        elif body[k].islower():
            cand = body[k : k + 2]
            if len(cand) == 2 and cand[1].islower() and cand.capitalize() in ELEMENTS and cand in ("se", "as", "te", "si"):
                sym = cand.capitalize()
                k += 2
            else:
                sym = body[k].upper()
                k += 1
            if sym not in ELEMENTS:
                raise SmilesError(f"unknown element {sym!r}")
            aromatic = True
    if sym is None:
        raise SmilesError("bracket atom without element")
    # chirality
    while k < len(body) and body[k] == "@":
        k += 1
        # named chirality classes like @TH1
        while k < len(body) and body[k].isupper() and body[k] in "THALSPBO":
            if body[k : k + 2] in ("TH", "AL", "SP", "TB", "OH"):
                k += 2
                while k < len(body) and body[k].isdigit():
                    k += 1
            break
    # explicit H count
    hcount = 0
    if k < len(body) and body[k] == "H":
        k += 1
        num = ""
        while k < len(body) and body[k].isdigit():
            num += body[k]
            k += 1
        hcount = int(num) if num else 1
    # charge
    charge = 0
    while k < len(body) and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        num = ""
        while k < len(body) and body[k].isdigit():
            num += body[k]
            k += 1
        if num:
            charge += sign * int(num)
        else:
            charge += sign
            # allow ++ / --
            while k < len(body) and body[k] in "+-" and body[k] == ("+" if sign > 0 else "-"):
                charge += sign
                k += 1
    # atom-map
    if k < len(body) and body[k] == ":":
        k += 1
        while k < len(body) and body[k].isdigit():
            k += 1
    if k != len(body):
        raise SmilesError(f"trailing bracket content {body[k:]!r}")
    return Atom(sym, aromatic=aromatic, charge=charge, explicit_h=hcount, isotope=isotope), j + 1


def parse_smiles(smiles: str) -> Molecule:
    """Parse a SMILES string into a Molecule.  Raises SmilesError on invalid
    input (mirrors RDKit MolFromSmiles returning None in the reference check,
    reference data/datareader.py:148)."""
    if not isinstance(smiles, str) or not smiles.strip():
        raise SmilesError("empty SMILES")
    s = smiles.strip()
    mol = Molecule()
    prev: Optional[int] = None
    pending_bond: Optional[str] = None
    branch_stack: List[Tuple[Optional[int], Optional[str]]] = []
    ring_map: Dict[str, Tuple[int, Optional[str]]] = {}
    i = 0
    n = len(s)

    def attach(idx: int):
        nonlocal prev, pending_bond
        if prev is None and pending_bond is not None:
            raise SmilesError("bond symbol with no preceding atom")
        if prev is not None:
            a_prev = mol.atoms[prev]
            a_new = mol.atoms[idx]
            if pending_bond is not None:
                order = BOND_ORDERS[pending_bond]
                aromatic = pending_bond == ":"
            elif a_prev.aromatic and a_new.aromatic:
                order, aromatic = 1.5, True
            else:
                order, aromatic = 1.0, False
            mol.add_bond(prev, idx, order, aromatic)
        prev = idx
        pending_bond = None

    while i < n:
        c = s[i]
        if c == "[":
            atom, i = _read_bracket_atom(s, i)
            attach(mol.add_atom(atom))
        elif c.isupper():
            two = s[i : i + 2]
            if two in ("Cl", "Br"):
                attach(mol.add_atom(Atom(two)))
                i += 2
            elif c in _ORGANIC_SUBSET:
                attach(mol.add_atom(Atom(c)))
                i += 1
            else:
                raise SmilesError(f"atom {c!r} requires brackets")
        elif c in _AROMATIC_ORGANIC:
            attach(mol.add_atom(Atom(c.upper(), aromatic=True)))
            i += 1
        elif c == "*":
            attach(mol.add_atom(Atom("*")))
            i += 1
        elif c in BOND_ORDERS:
            if pending_bond is not None:
                raise SmilesError("two bond symbols in a row")
            pending_bond = c
            i += 1
        elif c == "(":
            if prev is None:
                raise SmilesError("branch before any atom")
            if pending_bond is not None:
                # 'C=(C)C' — RDKit rejects a bond symbol before a branch
                # open; dropping it would silently change the structure
                raise SmilesError("bond symbol before '('")
            branch_stack.append((prev, None))
            i += 1
        elif c == ")":
            if not branch_stack:
                raise SmilesError("unmatched ')'")
            if pending_bond is not None:
                raise SmilesError("dangling bond symbol before ')'")
            prev, pending_bond = branch_stack.pop()
            pending_bond = None
            i += 1
        elif c.isdigit() or c == "%":
            if prev is None:
                raise SmilesError("ring closure before any atom")
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    raise SmilesError("bad %nn ring closure")
                key = s[i + 1 : i + 3]
                i += 3
            else:
                key = c
                i += 1
            if key in ring_map:
                other, obond = ring_map.pop(key)
                if other == prev:
                    raise SmilesError("ring closure to self")
                bond_sym = pending_bond or obond
                a1, a2 = mol.atoms[other], mol.atoms[prev]
                if bond_sym is not None:
                    order = BOND_ORDERS[bond_sym]
                    aromatic = bond_sym == ":"
                elif a1.aromatic and a2.aromatic:
                    order, aromatic = 1.5, True
                else:
                    order, aromatic = 1.0, False
                mol.add_bond(other, prev, order, aromatic)
                pending_bond = None
            else:
                ring_map[key] = (prev, pending_bond)
                pending_bond = None
        elif c == ".":
            if pending_bond is not None:
                raise SmilesError("dangling bond symbol before '.'")
            prev = None
            i += 1
        elif c in " \t":
            break  # SMILES ends at whitespace (title section)
        else:
            raise SmilesError(f"unexpected character {c!r} at {i}")

    if pending_bond is not None:
        raise SmilesError("dangling bond symbol at end of SMILES")
    if branch_stack:
        raise SmilesError("unmatched '('")
    if ring_map:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_map)}")
    if mol.num_atoms() == 0:
        raise SmilesError("no atoms")
    mol.perceive_rings()
    return mol


def is_valid_smiles(smiles: str) -> bool:
    """Validity as the FEATURIZER will see it: when RDKit is installed the
    conformer provider is RDKit, so the filter must apply RDKit's stricter
    rules (e.g. kekulization) too — otherwise a string this parser accepts
    sails past the reader's filter and crashes mid-featurization."""
    try:
        parse_smiles(smiles)
    except Exception:
        return False
    try:
        from rdkit import Chem  # type: ignore

        return Chem.MolFromSmiles(smiles) is not None
    except ImportError:
        return True
