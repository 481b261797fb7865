"""The port's native C++ chemistry (mmdti_tpu_torch/chem/native.py over its
own build of mmdti_tpu_torch/csrc/mmchem.cpp) against the JAX package's
binding of its own build (tests/conftest.py runs `make -C csrc`): parse,
terms, embed, refine and the distance matrix bit for bit, on the SMILES of
tests/test_device_refine.py and a seeded fuzz set; the native refinement
against the numpy ``_refine`` within 1e-4 A; an out-of-range index comes
back as a nonzero rc; the library builds once under a file lock, from the
port's source only, and a failed build raises with the compiler's output.
"""

import os
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest

import mmdti_tpu.chem.native as jax_native
from mmdti_tpu.chem.smiles import parse_smiles as jax_parse
from mmdti_tpu_torch.chem import native
from mmdti_tpu_torch.chem.conformer import _build_terms, _refine
from mmdti_tpu_torch.chem.smiles import parse_smiles
from mmdti_tpu_torch.ops import _build

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
CORPUS = SMILES + [
    "C#N", "[Na+].[Cl-]", "B(O)(O)c1ccccc1", "C1CC1", "O=C=O", "c1ccsc1", "c1cc[nH]c1",
    "[O-]C(=O)C", "[NH4+]", "C[C@H](N)C(=O)O", "[Se]1C=CC=C1", "C/C=C/C", "C1CC1.CCO",
    "C%10CCCCC%10", "O=S(=O)(O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C", "FC(F)(F)c1ccccc1",
    "C" * 20 + "O" + "C" * 15 + "O" + "C" * 14,   # ~150 atoms: the pruned-refine regime
]
REFINE_ATOL = 1e-4   # native (float64 inside) against numpy float64, as tests/test_chem.py


def _fuzz(n=300, seed=0):
    rng = np.random.RandomState(seed)
    alphabet = list("CCCNOSPcnos()[]=#-+123@Hl BrF/\\%.*")
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24))) for _ in range(n)]


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not jax_native.parse_available():
        pytest.fail("the JAX package's libmmchem.so did not build (tests/conftest.py)")
    assert native.available()


def _init(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * max(1.5, 0.8 * n ** (1 / 3) * 2)).astype(np.float32)


def test_library_is_the_ports_own_build(monkeypatch):
    path = native._lib()._name
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path) == os.path.basename(_build.host_library_path("mmchem"))
    # the port's copy: the JAX package's source line for line, its code
    # verbatim (one comment names the reference without a machine path)
    with open(os.path.join(_build.CSRC, "mmchem.cpp")) as a, open(
            os.path.join(os.path.dirname(_build.CSRC), "..", "csrc", "mmchem.cpp")) as b:
        ours, theirs = a.read().splitlines(), b.read().splitlines()
    assert len(ours) == len(theirs)
    assert [re.sub(r"//.*", "", ln) for ln in ours] == [re.sub(r"//.*", "", ln) for ln in theirs]
    assert native._lib().mmchem_abi_version() == native.ABI_VERSION == 4
    # MMCHEM_LIB and csrc/libmmchem.so play no part
    monkeypatch.setenv("MMCHEM_LIB", os.path.join(_build.BUILD_DIR, "missing.so"))
    monkeypatch.setattr(native, "_LIB", None)
    assert native._lib()._name == path


def test_wrong_abi_raises():
    class Entry:
        def __call__(self):
            return 3

    class Lib:
        mmchem_abi_version = Entry()

    with pytest.raises(RuntimeError, match="ABI 3, expected 4"):
        native._bind(Lib())


@pytest.mark.parametrize("corpus", ["named", "fuzz"])
def test_parse_and_terms_bit_equal_to_jax(corpus):
    smis = CORPUS if corpus == "named" else _fuzz()
    accepted = 0
    for smi in smis:
        ours, theirs = native.parse_graph(smi), jax_native.parse_graph(smi)
        assert (ours is None) == (theirs is None), smi
        if ours is None:
            continue
        accepted += 1
        assert ours[0] == theirs[0], smi
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=smi)
        mol, jmol = parse_smiles(smi).add_hydrogens(), jax_parse(smi).add_hydrogens()
        t_ours, t_theirs = native.bond_angle_terms(mol), jax_native.bond_angle_terms(jmol)
        for a, b in zip(t_ours, t_theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=smi)
    assert accepted >= 10


@pytest.mark.parametrize("smi", CORPUS)
def test_embed_refine_distance_bit_equal_to_jax(smi):
    mol, jmol = parse_smiles(smi).add_hydrogens(), jax_parse(smi).add_hydrogens()
    c0 = _init(mol.num_atoms())
    emb = native.embed_coords(mol, c0.copy())
    np.testing.assert_array_equal(emb, jax_native.embed_coords(jmol, c0.copy()))
    if mol.num_atoms() <= 40:   # the pair-list entry builds O(n^2) terms in Python
        ref = native.refine_coords(mol, c0.copy())
        np.testing.assert_array_equal(ref, jax_native.refine_coords(jmol, c0.copy()))
        np.testing.assert_allclose(ref, _refine(c0.copy(), _build_terms(mol)), atol=REFINE_ATOL)
    np.testing.assert_allclose(emb, _refine(c0.copy(), _build_terms(mol)), atol=REFINE_ATOL)
    np.testing.assert_array_equal(native.distance_matrix(emb), jax_native.distance_matrix(emb))


def test_out_of_range_indices_rejected_not_crash():
    import ctypes

    lib = native._lib()
    n = 4
    x = np.zeros((n, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    for bad in (np.array([[0, n]], np.int32), np.array([[-1, 1]], np.int32)):
        bidx = np.ascontiguousarray(bad)
        blen = np.ones((1,), np.float32)
        rc = lib.mmchem_refine(n, x.ctypes.data_as(fp), 1, bidx.ctypes.data_as(ip),
                               blen.ctypes.data_as(fp), 0, None, None, 0, None, 10)
        assert rc != 0


def test_builtin_ladder_declines_to_numpy(monkeypatch):
    """numpy ``_refine`` runs only where both native entries decline."""
    from mmdti_tpu_torch.chem import conformer

    atoms, native_coords = conformer.builtin_smi2coords("CC(=O)O", seed=3)
    monkeypatch.setattr(native, "embed_coords", lambda *a, **k: None)
    _, via_refine = conformer.builtin_smi2coords("CC(=O)O", seed=3)
    np.testing.assert_array_equal(via_refine, native_coords)   # same C++ refinement
    monkeypatch.setattr(native, "refine_coords", lambda *a, **k: None)
    _, via_numpy = conformer.builtin_smi2coords("CC(=O)O", seed=3)
    np.testing.assert_allclose(via_numpy, native_coords, atol=REFINE_ATOL)


def test_build_is_locked_and_atomic(tmp_path, monkeypatch):
    """Four threads building at once (flock excludes them as it excludes
    processes): one compile, one library, no temporary file left."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    runs = []
    real_run = subprocess.run

    def counting_run(cmd, *a, **k):
        runs.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(_build.subprocess, "run", counting_run)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(_build.build_host_library("mmchem")))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1 and len(set(paths)) == 1 and len(paths) == 4
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(paths[0]), "libmmchem.lock", "mmchem.log"])
    assert "-O3 -fPIC -shared -std=c++17" in " ".join(runs[0])
    assert not any("march" in arg for arg in runs[0])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "mmchem.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed to build mmchem.cpp") as err:
        _build.build_host_library("mmchem")
    assert "error" in str(err.value)
    assert not os.path.exists(_build.host_library_path("mmchem"))


def test_same_compiler_and_flags_as_the_makefile():
    """Bit-equality with the JAX package's build needs make's compiler and
    flags: the Makefile's CXXFLAGS without MARCH."""
    with open(os.path.join(os.path.dirname(_build.CSRC), "..", "csrc", "Makefile")) as f:
        text = f.read()
    assert "CXXFLAGS ?= -O3 -fPIC -shared -std=c++17 $(MARCH)" in text
    assert _build.HOST_CXX_FLAGS == ("-O3", "-fPIC", "-shared", "-std=c++17")
    assert _build.host_compiler() == shutil.which(os.environ.get("CXX") or "g++")
