"""SMILES tokenizer for the ChemBERTa text stream.

Copy of mmdti_tpu.chem.tokenizer without the HF adapter: a built-in regex
atom-level SMILES tokenizer with a fixed vocabulary (self-contained,
deterministic, RoBERTa-style specials <s>=0 <pad>=1 </s>=2 <unk>=3) and the
`__call__(list_of_smiles, ...) -> {'input_ids', 'attention_mask'}` contract
the collate path needs.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# The standard SMILES tokenization regex (atom-level), as used across the
# chemistry-LM literature (e.g. the Molecular Transformer / ChemBERTa line).
_SMI_REGEX = re.compile(
    r"(\[[^\]]+\]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|"
    r"\(|\)|\.|=|#|-|\+|\\|\/|:|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])"
)

_BASE_TOKENS: List[str] = (
    list("BCNOSPFI") + ["Br", "Cl", "b", "c", "n", "o", "s", "p"]
    + ["(", ")", ".", "=", "#", "-", "+", "\\", "/", ":", "~", "@", "?", ">", "*", "$"]
    + [str(d) for d in range(10)]
    + ["%" + f"{d:02d}" for d in range(10, 50)]
    + [
        "[nH]", "[H]", "[C@H]", "[C@@H]", "[C@]", "[C@@]", "[N+]", "[N-]",
        "[O-]", "[O+]", "[S+]", "[S-]", "[n+]", "[n-]", "[NH+]", "[NH2+]",
        "[NH3+]", "[NH-]", "[OH+]", "[OH-]", "[CH]", "[CH2]", "[CH-]",
        "[CH2-]", "[C-]", "[C+]", "[cH-]", "[c-]", "[c+]", "[o+]", "[s+]",
        "[P+]", "[P@]", "[P@@]", "[PH]", "[S@]", "[S@@]", "[S@+]", "[S@@+]",
        "[Si]", "[SiH]", "[SiH2]", "[SiH3]", "[B-]", "[BH-]", "[BH2-]",
        "[BH3-]", "[Se]", "[SeH]", "[se]", "[te]", "[As]", "[AsH]",
        "[Na+]", "[Na]", "[K+]", "[K]", "[Li+]", "[Li]", "[Mg+2]", "[Mg]",
        "[Ca+2]", "[Ca]", "[Al]", "[Al+3]", "[Zn+2]", "[Zn]", "[Fe+2]",
        "[Fe+3]", "[Fe]", "[Cu+2]", "[Cu]", "[Mn+2]", "[Mn]", "[Cr]",
        "[Hg]", "[Hg+2]", "[Pt]", "[Pt+2]", "[Au]", "[Au+]", "[Sn]",
        "[Sn+2]", "[Pb]", "[Pb+2]", "[Ag+]", "[Ag]", "[Cd+2]", "[Cd]",
        "[Ba+2]", "[Sr+2]", "[Cs+]", "[I-]", "[Br-]", "[Cl-]", "[F-]",
        "[NH4+]", "[N@]", "[N@@]", "[N@+]", "[N@@+]", "[13C]", "[13CH]",
        "[13CH2]", "[13CH3]", "[2H]", "[3H]", "[125I]", "[18F]", "[S@@]",
    ]
)


class SmilesTokenizer:
    """Built-in fixed-vocab regex SMILES tokenizer (RoBERTa-style specials)."""

    def __init__(self, max_len: int = 512):
        self.bos_token, self.pad_token, self.eos_token, self.unk_token = (
            "<s>", "<pad>", "</s>", "<unk>",
        )
        self.vocab: Dict[str, int] = {
            "<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4,
        }
        for tok in _BASE_TOKENS:
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.pad_token_id = self.vocab["<pad>"]
        self.bos_token_id = self.vocab["<s>"]
        self.eos_token_id = self.vocab["</s>"]
        self.unk_token_id = self.vocab["<unk>"]
        self.max_len = max_len
        self._encode_cache: Dict[str, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, smiles: str) -> List[str]:
        toks = _SMI_REGEX.findall(smiles)
        # any residue the regex missed falls back to characters
        if "".join(toks) != smiles:
            toks, i = [], 0
            for m in _SMI_REGEX.finditer(smiles):
                if m.start() > i:
                    toks.extend(list(smiles[i : m.start()]))
                toks.append(m.group(0))
                i = m.end()
            toks.extend(list(smiles[i:]))
        return toks

    def encode(self, smiles: str, truncation: bool = True) -> List[int]:
        # truncation is part of the key: a cached untruncated encoding must
        # not answer a truncation=True call with ids past max_len
        key = (smiles, truncation)
        cached = self._encode_cache.get(key)
        if cached is not None:
            return cached
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(smiles)]
        if truncation and len(ids) > self.max_len - 2:
            ids = ids[: self.max_len - 2]
        out = [self.bos_token_id] + ids + [self.eos_token_id]
        if len(self._encode_cache) < 1_000_000:
            self._encode_cache[key] = out
        return out

    def __call__(
        self,
        smiles_list: Sequence[str],
        padding: bool = True,
        truncation: bool = True,
        pad_to: Optional[int] = None,
        **_,
    ) -> Dict[str, np.ndarray]:
        encoded = [self.encode(s, truncation=truncation) for s in smiles_list]
        max_l = max(len(e) for e in encoded)
        if pad_to is not None:
            max_l = max(max_l, int(pad_to))
        ids = np.full((len(encoded), max_l), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(encoded), max_l), dtype=np.int64)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(chemberta_dir: Optional[str] = None, max_len: int = 512):
    """The built-in tokenizer.  A ChemBERTa checkpoint dir would need the HF
    tokenizer, which this package does not load: such a dir raises."""
    if chemberta_dir:
        raise ValueError(
            f"chemberta_dir={chemberta_dir!r}: HF tokenizers are not supported "
            "by mmdti_tpu_torch; only the built-in SMILES tokenizer is"
        )
    return SmilesTokenizer(max_len=max_len)
