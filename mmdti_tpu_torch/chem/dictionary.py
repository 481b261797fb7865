"""Atom-token dictionary.

Pure-Python re-implementation of the token map the reference gets from
unicore's ``Dictionary`` (reference data/conformer.py:65-66,
reference models/mm_model.py:435-438).  Index layout matches unicore:
specials first in the order bos([CLS])=0, pad([PAD])=1, eos([SEP])=2,
unk([UNK])=3, then the file symbols, then any ``add_symbol`` extras such as
``[MASK]``.
"""

from __future__ import annotations

import os
from typing import List, Optional

DEFAULT_DICT = os.path.join(os.path.dirname(__file__), "mol.dict.txt")


class Dictionary:
    def __init__(
        self,
        bos: str = "[CLS]",
        pad: str = "[PAD]",
        eos: str = "[SEP]",
        unk: str = "[UNK]",
    ):
        self.symbols: List[str] = []
        self.indices = {}
        self.counts: List[int] = []
        self.specials = set()
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        self.bos_index = self.add_symbol(bos, is_special=True)
        self.pad_index = self.add_symbol(pad, is_special=True)
        self.eos_index = self.add_symbol(eos, is_special=True)
        self.unk_index = self.add_symbol(unk, is_special=True)

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def add_symbol(self, word: str, n: int = 1, is_special: bool = False) -> int:
        if word in self.indices:
            idx = self.indices[word]
            self.counts[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.counts.append(n)
        if is_special:
            self.specials.add(word)
        return idx

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else self.unk_word

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Dictionary":
        """Load a dictionary from a unicore-format text file.

        Each non-empty line is ``symbol [count]``.  ``path=None`` loads the
        packaged default atom vocabulary; an explicit path that does not
        exist raises (silently substituting the default would shift every
        atom token index — garbage predictions with no error).
        """
        d = cls()
        if path is None:
            path = DEFAULT_DICT
        elif not os.path.exists(path):
            raise FileNotFoundError(f"atom dictionary not found: {path!r}")
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                sym = parts[0]
                n = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 1
                d.add_symbol(sym, n=n)
        return d

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for sym, n in zip(self.symbols, self.counts):
                if sym in self.specials:
                    continue
                f.write(f"{sym} {n}\n")
