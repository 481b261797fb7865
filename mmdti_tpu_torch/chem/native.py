"""ctypes binding to the native C++ chemistry (port of mmdti_tpu/chem/native.py).

The library is the port's own: ``mmdti_tpu_torch/csrc/mmchem.cpp``, built
with the host compiler at first use (ops/_build.py ``build_host_library``;
the JAX package's csrc/Makefile flags) and loaded from there only.  Its ABI
must be version 4 exactly.  It refines conformers (the graph -> terms ->
refine entry ``mmchem_embed`` and the pair-list entry ``mmchem_refine``),
parses SMILES with hydrogen expansion (``mmchem_parse``), builds the 1-3
angle terms (``mmchem_terms``) and the pairwise distance matrix, bit for bit
as the JAX package's build of the same source does.

A failed build or a wrong ABI raises: nothing falls back to numpy for want
of the library.  An entry point that declines its input (a nonzero rc: an
index out of range, a parse error, a term cap overflowed) returns None, and
the caller takes its next rung.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

ABI_VERSION = 4

_LIB = None
_LOCK = threading.Lock()

_F = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_DP = ctypes.POINTER(ctypes.c_double)


def _bind(lib) -> None:
    lib.mmchem_abi_version.restype = ctypes.c_int
    abi = lib.mmchem_abi_version()
    if abi != ABI_VERSION:
        raise RuntimeError(f"libmmchem ABI {abi}, expected {ABI_VERSION}")
    lib.mmchem_refine.restype = ctypes.c_int
    lib.mmchem_refine.argtypes = [
        ctypes.c_int,      # n atoms
        _F,                # coords [n,3] in/out
        ctypes.c_int,      # n bond terms
        _IP,               # bond idx [nb,2]
        _F,                # bond len [nb]
        ctypes.c_int,      # n angle terms
        _IP,
        _F,
        ctypes.c_int,      # n nonbonded
        _IP,
        ctypes.c_int,      # iters
    ]
    lib.mmchem_distance_matrix.restype = None
    lib.mmchem_distance_matrix.argtypes = [ctypes.c_int, _F, _F]
    lib.mmchem_embed.restype = ctypes.c_int
    lib.mmchem_embed.argtypes = [
        ctypes.c_int,      # n atoms
        _F,                # coords [n,3] in/out
        ctypes.c_int,      # n bonds
        _IP,               # bonds [nb,2]
        _DP,               # orders [nb]
        _DP,               # bond lengths [nb]
        _IP,               # flags [n]
        ctypes.c_int,      # iters
    ]
    lib.mmchem_terms.restype = ctypes.c_int
    lib.mmchem_terms.argtypes = [
        ctypes.c_int,      # n atoms
        ctypes.c_int,      # n bonds
        _IP,               # bonds [nb,2]
        _DP,               # orders [nb]
        _DP,               # bond lens [nb]
        _IP,               # flags [n]
        ctypes.c_int,      # cap_na
        _IP,               # out aidx
        _F,                # out alen
    ]
    lib.mmchem_parse.restype = ctypes.c_int
    lib.mmchem_parse.argtypes = [
        ctypes.c_char_p,                  # smiles
        ctypes.c_int,                     # cap_atoms
        ctypes.POINTER(ctypes.c_char),    # sym_out [cap*3]
        _IP,                              # flags_out
        ctypes.c_int,                     # cap_bonds
        _IP,                              # bonds_out
        _DP,                              # orders_out
        _IP,                              # n_bonds_out
    ]


def _lib():
    """The loaded library, built from the port's source at first use."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                from mmdti_tpu_torch.ops._build import build_host_library

                lib = ctypes.CDLL(build_host_library("mmchem"))
                _bind(lib)
                _LIB = lib
    return _LIB


def available() -> bool:
    """True once the library is built and bound (a failed build raises)."""
    return _lib() is not None


def parse_graph(smiles: str):
    """Native SMILES parse + implicit-H expansion.

    Returns (symbols list[str], flags int32 [n], bonds int32 [nb,2],
    orders float64 [nb]): the graph ``parse_smiles(s).add_hydrogens()``
    produces, atoms in the same order (heavy atoms in parse order, each
    one's hydrogens after them), or None when the parse fails (the caller
    then runs the Python parser, which raises the detailed SmilesError)."""
    lib = _lib()
    raw = smiles.encode("utf-8", errors="ignore")
    # every atom takes at least one character and adds at most 4 hydrogens
    cap_atoms = 8 * max(len(raw), 4) + 8
    cap_bonds = cap_atoms + cap_atoms // 2 + 8
    sym = ctypes.create_string_buffer(3 * cap_atoms)
    flags = np.empty(cap_atoms, dtype=np.int32)
    bonds = np.empty((cap_bonds, 2), dtype=np.int32)
    orders = np.empty(cap_bonds, dtype=np.float64)
    nb_out = ctypes.c_int(0)
    n = lib.mmchem_parse(
        raw, cap_atoms, sym, flags.ctypes.data_as(_IP),
        cap_bonds, bonds.ctypes.data_as(_IP), orders.ctypes.data_as(_DP),
        ctypes.byref(nb_out),
    )
    if n < 0:
        return None
    nb = int(nb_out.value)
    blob = sym.raw
    syms = [blob[3 * i: 3 * i + 3].rstrip(b"\x00").decode() for i in range(n)]
    return syms, flags[:n].copy(), bonds[:nb].copy(), orders[:nb].copy()


def _marshal_graph(mol):
    """Per-atom flags and per-bond index, order and ideal-length arrays
    (the bond lengths from conformer._ideal_bond_length, so the constants
    have one source)."""
    from mmdti_tpu_torch.chem.conformer import _ideal_bond_length

    syms = [a.symbol for a in mol.atoms]
    flags = np.array(
        [(1 if a.aromatic else 0) | (2 if s == "B" else 0)
         for a, s in zip(mol.atoms, syms)],
        dtype=np.int32,
    )
    bonds = np.ascontiguousarray(
        np.array([[b.a1, b.a2] for b in mol.bonds], dtype=np.int32).reshape(-1, 2)
    )
    orders = np.array([b.order for b in mol.bonds], dtype=np.float64)
    blens = np.array(
        [_ideal_bond_length(syms[b.a1], syms[b.a2], b.order) for b in mol.bonds],
        dtype=np.float64,
    )
    return flags, bonds, orders, blens


def angle_terms_from_arrays(n, bonds, orders, blens, flags):
    """mmchem_terms over marshalled arrays: (aidx int32 [NA,2], alen f32
    [NA]), or None when the entry declines (cap overflow, bad input)."""
    lib = _lib()
    bonds = np.ascontiguousarray(bonds, dtype=np.int32)
    orders = np.ascontiguousarray(orders, dtype=np.float64)
    blens = np.ascontiguousarray(blens, dtype=np.float64)
    flags = np.ascontiguousarray(flags, dtype=np.int32)
    cap = max(16, 8 * int(n))
    aidx = np.empty((cap, 2), dtype=np.int32)
    alen = np.empty(cap, dtype=np.float32)
    na = lib.mmchem_terms(
        int(n), len(orders), bonds.ctypes.data_as(_IP),
        orders.ctypes.data_as(_DP), blens.ctypes.data_as(_DP),
        flags.ctypes.data_as(_IP),
        cap, aidx.ctypes.data_as(_IP), alen.ctypes.data_as(_F),
    )
    if na < 0:
        return None
    return aidx[:na].copy(), alen[:na].copy()


def bond_angle_terms(mol):
    """Native twin of conformer._bond_angle_terms (without the seen13 set):
    (bidx int32 [NB,2], blen f32, aidx int32 [NA,2], alen f32), or None when
    the entry declines.  Bit-exact with the Python builder."""
    flags, bonds, orders, blens = _marshal_graph(mol)
    out = angle_terms_from_arrays(mol.num_atoms(), bonds, orders, blens, flags)
    if out is None:
        return None
    aidx, alen = out
    return bonds, blens.astype(np.float32), aidx, alen


def _check_rows(coords: np.ndarray, n: int) -> None:
    if coords.shape[0] != n:
        raise ValueError(
            f"coords rows ({coords.shape[0]}) != mol atoms ({n}); refusing to "
            "hand mismatched buffers to the native kernel"
        )


def embed_coords(mol, coords: np.ndarray, iters: int = 300) -> Optional[np.ndarray]:
    """Terms and refinement in C++ from the molecule's graph: only the
    O(n + bonds) marshalling runs in Python.  None when the entry declines."""
    lib = _lib()
    n = mol.num_atoms()
    _check_rows(coords, n)
    flags, bonds, orders, blens = _marshal_graph(mol)
    x = np.ascontiguousarray(coords, dtype=np.float32).copy()
    rc = lib.mmchem_embed(
        n, x.ctypes.data_as(_F), len(orders), bonds.ctypes.data_as(_IP),
        orders.ctypes.data_as(_DP), blens.ctypes.data_as(_DP),
        flags.ctypes.data_as(_IP), iters,
    )
    if rc != 0:
        return None
    return x


def refine_coords(mol, coords: np.ndarray, iters: int = 300) -> Optional[np.ndarray]:
    """The C++ refinement over the Python-built term lists
    (conformer._build_terms).  None when the entry declines."""
    from mmdti_tpu_torch.chem.conformer import _build_terms

    lib = _lib()
    _check_rows(coords, mol.num_atoms())
    bidx, blen, aidx, alen, nidx = _build_terms(mol)
    x = np.ascontiguousarray(coords, dtype=np.float32).copy()
    bidx = np.ascontiguousarray(bidx, dtype=np.int32)
    blen = np.ascontiguousarray(blen, dtype=np.float32)
    aidx = np.ascontiguousarray(aidx, dtype=np.int32)
    alen = np.ascontiguousarray(alen, dtype=np.float32)
    nidx = np.ascontiguousarray(nidx, dtype=np.int32)
    rc = lib.mmchem_refine(
        x.shape[0], x.ctypes.data_as(_F),
        len(blen), bidx.ctypes.data_as(_IP), blen.ctypes.data_as(_F),
        len(alen), aidx.ctypes.data_as(_IP), alen.ctypes.data_as(_F),
        len(nidx), nidx.ctypes.data_as(_IP),
        iters,
    )
    if rc != 0:
        return None
    return x


def distance_matrix(coords: np.ndarray) -> np.ndarray:
    """[n, n] float32 pairwise distances of [n, 3] coordinates."""
    lib = _lib()
    x = np.ascontiguousarray(coords, dtype=np.float32)
    n = x.shape[0]
    out = np.empty((n, n), dtype=np.float32)
    lib.mmchem_distance_matrix(n, x.ctypes.data_as(_F), out.ctypes.data_as(_F))
    return out
