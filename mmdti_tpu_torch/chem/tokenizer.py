"""SMILES tokenizers for the ChemBERTa text stream (port of
mmdti_tpu/chem/tokenizer.py).

* ``SmilesTokenizer``: the built-in regex atom-level SMILES tokenizer with
  a fixed vocabulary (self-contained, deterministic, RoBERTa-style specials
  <s>=0 <pad>=1 </s>=2 <unk>=3), used when no checkpoint dir is given.
* ``RobertaBPETokenizer``: the byte-level BPE of a ChemBERTa (RoBERTa)
  checkpoint dir, read from its vocab.json, merges.txt and token configs
  without ``transformers``: the ids, masks, ``pad_token_id`` and
  ``vocab_size`` that the JAX package's HFTokenizerAdapter returns from
  ``AutoTokenizer`` (a RobertaTokenizerFast).

Both expose the ``__call__(list_of_smiles, ...) -> {'input_ids',
'attention_mask'}`` contract the collate path needs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---- RoBERTa byte-level BPE ----------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\u00a1"), ord("\u00ac") + 1))
          + list(range(ord("\u00ae"), ord("\u00ff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# Unicode's White_Space characters: what \s means to the Rust regex HF's
# tokenizers use (Python's \s also takes \x1c-\x1f)
_WS = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
# GPT-2's pre-tokenizer with the standard library's re: \p{L} becomes
# [^\W\d_] and \p{N} becomes \d.  Exact on ASCII, so on every SMILES;
# beyond it, characters of Unicode's No and Nl classes (superscripts,
# Roman numerals) group with the letters here and with the digits there
_PRETOKENIZE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^" + _WS + r"\w]|_)+"
    r"|[" + _WS + r"]+(?![^" + _WS + r"])|[" + _WS + r"]+")
_SPECIALS = (("bos_token", "<s>"), ("eos_token", "</s>"), ("unk_token", "<unk>"),
             ("pad_token", "<pad>"), ("mask_token", "<mask>"))
VERY_LARGE = int(1e30)   # HF's model_max_length when a dir names none


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_text(tok) -> Tuple[str, bool]:
    """A special token as the configs write it (a string or an AddedToken
    dict) -> (its text, whether it takes the spaces before it)."""
    if isinstance(tok, dict):
        return tok["content"], bool(tok.get("lstrip", False))
    return tok, False


class RobertaBPETokenizer:
    """A RoBERTa byte-level BPE tokenizer read from an HF dir: vocab.json
    and merges.txt, the special tokens of tokenizer_config.json,
    special_tokens_map.json and added_tokens.json where present, and
    ``model_max_length``.  Each SMILES encodes to ``<s> ... </s>``; with
    ``pad_to`` the rows are truncated to ``pad_to`` (keeping ``</s>``) and
    padded to it, as HF's ``padding="max_length", max_length=pad_to``;
    without it they are padded to the longest and truncated to
    ``model_max_length``."""

    def __init__(self, model_dir: str):
        self.vocab: Dict[str, int] = _read_json(os.path.join(model_dir, "vocab.json"))
        with open(os.path.join(model_dir, "merges.txt"), encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
        merges = [tuple(ln.split(" ")) for ln in lines
                  if ln and not ln.startswith("#version")]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        config = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        specials_map = _read_json(os.path.join(model_dir, "special_tokens_map.json"))
        self.added = dict(_read_json(os.path.join(model_dir, "added_tokens.json")))
        self.special: Dict[str, str] = {}
        lstrip = set()
        for name, default in _SPECIALS:
            text, strip = _token_text(specials_map.get(name, config.get(name, default)))
            self.special[name] = text
            if strip or name == "mask_token":   # RoBERTa's <mask> takes the space before it
                lstrip.add(text)
        self.ids = {**self.vocab, **self.added}
        for name, text in self.special.items():
            if text not in self.ids:
                raise ValueError(f"{model_dir}: the {name} {text!r} is in neither vocab.json "
                                 "nor added_tokens.json")
        self.bos_token_id = self.ids[self.special["bos_token"]]
        self.eos_token_id = self.ids[self.special["eos_token"]]
        self.pad_token_id = self.ids[self.special["pad_token"]]
        self.unk_token_id = self.ids[self.special["unk_token"]]
        self.vocab_size = len(self.vocab)
        self.model_max_length = int(config.get("model_max_length", VERY_LARGE))
        texts = sorted({*self.special.values(), *self.added}, key=len, reverse=True)
        self._split = re.compile("|".join(
            (r"[" + _WS + r"]*" if t in lstrip else "") + "(" + re.escape(t) + ")"
            for t in texts))
        self._byte_map = _bytes_to_unicode()
        self._encode_cache: Dict[str, List[int]] = {}

    def _bpe(self, word: str) -> List[str]:
        """GPT-2's merge loop: the lowest-ranked adjacent pair merges
        everywhere, until no pair has a rank."""
        parts = list(word)
        while len(parts) > 1:
            pair = min(zip(parts, parts[1:]), key=lambda p: self.ranks.get(p, VERY_LARGE))
            if pair not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return parts

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _PRETOKENIZE.findall(text):
            mapped = "".join(self._byte_map[b] for b in piece.encode("utf-8"))
            ids.extend(self.ids.get(t, self.unk_token_id) for t in self._bpe(mapped))
        return ids

    def encode(self, smiles: str) -> List[int]:
        """The content ids of ``smiles`` (no <s>, </s>), cached."""
        cached = self._encode_cache.get(smiles)
        if cached is not None:
            return cached
        ids, pos = [], 0
        for m in self._split.finditer(smiles):
            ids.extend(self._encode_text(smiles[pos:m.start()]))
            ids.append(self.ids[m.group(1)])
            pos = m.end()
        ids.extend(self._encode_text(smiles[pos:]))
        if len(self._encode_cache) < 1_000_000:
            self._encode_cache[smiles] = ids
        return ids

    def __call__(self, smiles_list: Sequence[str], padding: bool = True,
                 truncation: bool = True, pad_to: Optional[int] = None,
                 **_) -> Dict[str, np.ndarray]:
        limit = int(pad_to) if pad_to is not None else self.model_max_length
        rows = []
        for s in smiles_list:
            ids = self.encode(s)
            if truncation and len(ids) > limit - 2:
                ids = ids[: max(limit - 2, 0)]
            rows.append([self.bos_token_id, *ids, self.eos_token_id])
        width = max(len(r) for r in rows)
        if pad_to is not None:
            width = max(width, int(pad_to))
        ids = np.full((len(rows), width), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(chemberta_dir: Optional[str] = None, max_len: int = 512):
    """The BPE tokenizer of a ChemBERTa checkpoint dir, or the built-in
    tokenizer when no dir is given (or the path is not a directory, as in
    the JAX package).  A dir without vocab.json and merges.txt raises; the
    JAX package falls back to the built-in tokenizer there (ROADMAP.md §3)."""
    if chemberta_dir and os.path.isdir(chemberta_dir):
        missing = [f for f in ("vocab.json", "merges.txt")
                   if not os.path.isfile(os.path.join(chemberta_dir, f))]
        if missing:
            raise FileNotFoundError(f"chemberta_dir {chemberta_dir!r} holds no {missing}: the "
                                    "RoBERTa BPE tokenizer reads vocab.json and merges.txt")
        return RobertaBPETokenizer(chemberta_dir)
    return SmilesTokenizer(max_len=max_len)
