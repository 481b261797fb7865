"""mmdti_tpu_torch's RoBERTa byte-level BPE tokenizer
(chem/tokenizer.py::RobertaBPETokenizer) against ``transformers``.

On the committed fixture tests/data/chemberta_bpe (tests/data/chemberta_bpe/
make_fixture.py), the port's ``load_tokenizer(dir)`` must give exactly the
input_ids and attention_mask of the JAX package's
``HFTokenizerAdapter(AutoTokenizer.from_pretrained(dir))`` (a
RobertaTokenizerFast): on tests/conftest.py's SMILES_20, on the repo's
synthetic molecules and on SMILES longer than the fixture's
model_max_length (512), without ``pad_to`` and with ``pad_to`` below and
above the longest row; and the same ``vocab_size`` and ``pad_token_id``.
"""

import os

os.environ.setdefault("USE_TF", "0")   # transformers would import TensorFlow otherwise

import numpy as np
import pytest
from transformers import AutoTokenizer

from mmdti_tpu.chem.tokenizer import HFTokenizerAdapter
from mmdti_tpu_torch.chem.tokenizer import RobertaBPETokenizer, SmilesTokenizer, load_tokenizer
from mmdti_tpu_torch.finetune import make_synthetic_dataset
from mmdti_tpu_torch.data.reader import read_csv
from tests.conftest import SMILES_20

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "chemberta_bpe")
LONG = ["CC(=O)Nc1ccc(O)cc1" * 60, "C" * 1500, "c1ccccc1" + "OCC" * 250, "CCO"]
ODD = ["[C@@H](N)C(=O)O", "[nH]1cccc1", "C#N.[Na+].[Cl-]", "CC <mask>C", "C\\C=C/C",
       "FC(F)(F)S(=O)(=O)[O-]", "Br/C=C\\Br", "[13CH3]O"]


@pytest.fixture(scope="module")
def both():
    return (HFTokenizerAdapter(AutoTokenizer.from_pretrained(FIXTURE)),
            load_tokenizer(FIXTURE))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "synthetic.csv")
    make_synthetic_dataset(path, n=400, seed=0)
    return list(read_csv(path)["smiles"])


def _assert_same(hf, port, smiles, **kw):
    a, b = hf(smiles, **kw), port(smiles, **kw)
    for k in ("input_ids", "attention_mask"):
        assert b[k].dtype == np.int64, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_vocab_size_and_pad_id_equal_hf(both):
    hf, port = both
    assert isinstance(port, RobertaBPETokenizer)
    assert port.vocab_size == hf.vocab_size
    assert port.pad_token_id == hf.pad_token_id == 1
    assert port.model_max_length == hf.tok.model_max_length == 512


@pytest.mark.parametrize("pad_to", [None, 6, 16, 40])
def test_smiles_20_equal_hf(both, pad_to):
    _assert_same(*both, SMILES_20, pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [None, 12, 64])
def test_synthetic_molecules_equal_hf(both, synthetic, pad_to):
    _assert_same(*both, synthetic, pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [None, 20, 600])
def test_smiles_past_model_max_length_equal_hf(both, pad_to):
    hf, port = both
    assert max(len(port.encode(s)) for s in LONG) > port.model_max_length
    _assert_same(hf, port, LONG, pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [None, 8])
def test_stereo_charges_and_specials_equal_hf(both, pad_to):
    _assert_same(*both, ODD, pad_to=pad_to)


def test_pad_to_truncates_and_keeps_eos(both):
    _, port = both
    out = port(["CC(=O)Oc1ccccc1C(=O)O"], pad_to=5)
    assert out["input_ids"].shape == (1, 5)
    assert out["input_ids"][0, 0] == port.bos_token_id
    assert out["input_ids"][0, -1] == port.eos_token_id
    assert out["attention_mask"].all()


def test_encode_cache_returns_the_same_ids(both):
    _, port = both
    first = port.encode("CCOc1ccccc1")
    assert port.encode("CCOc1ccccc1") is first


def test_no_dir_gives_the_built_in_tokenizer():
    assert isinstance(load_tokenizer(None), SmilesTokenizer)
    assert isinstance(load_tokenizer(""), SmilesTokenizer)


def test_dir_without_vocab_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        load_tokenizer(str(tmp_path))
