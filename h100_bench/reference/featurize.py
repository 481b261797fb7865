"""The reference's own featurization of a crystal (Uni-MOF's
coords2unimol_mof): a crystal of more than ``max_atoms`` atoms keeps
``max_atoms`` of them chosen without replacement by
``numpy.random.RandomState(crop_seed).choice``; the tokens are BOS, the
atoms' dictionary indices (unknown symbols take [UNK]) and EOS; the
coordinates are centred on the kept atoms, with zero BOS and EOS rows;
everything is padded to ``pad`` with the pad token and zero coordinates.
"""

from __future__ import annotations

import numpy as np


def crystal_tokens(cfg: dict, symbols, coords, crop_seed: int, max_atoms: int, pad: int):
    """(tokens [pad] int64, coordinates [pad, 3] float32)."""
    vocab = cfg["atom_vocab"]
    symbols = np.asarray(symbols)
    coords = np.asarray(coords, np.float32)
    if len(symbols) > max_atoms:
        idx = np.random.RandomState(crop_seed).choice(len(symbols), max_atoms, replace=False)
        symbols, coords = symbols[idx], coords[idx]
    unk = vocab.index("[UNK]")
    ids = [vocab.index(s) if s in vocab else unk for s in symbols]
    n = len(ids) + 2
    tokens = np.full(pad, cfg["atom_pad_idx"], np.int64)
    tokens[:n] = [vocab.index("[CLS]"), *ids, vocab.index("[SEP]")]
    out = np.zeros((pad, 3), np.float32)
    out[1:n - 1] = coords - coords.mean(axis=0)
    return tokens, out


def crystal_batch(cfg: dict, data: dict, rows, max_atoms: int, pad: int) -> dict:
    """The model inputs of crystals ``rows`` of a traffic.crystals set."""
    toks, crds = zip(*(crystal_tokens(cfg, data["symbols"][r], data["coords"][r],
                                      data["crop_seeds"][r], max_atoms, pad) for r in rows))
    rows = list(rows)
    return {"src_tokens": np.stack(toks), "src_coord": np.stack(crds),
            "gas_id": data["gas_id"][rows], "gas_attr": data["gas_attr"][rows],
            "pressure": data["pressure"][rows], "temperature": data["temperature"][rows]}
