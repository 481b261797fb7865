"""The one generator of the benchmark's inputs, driven by a mix's
``dataset`` parameters and the run's seed.

Two kinds of data set:

* ``molecules``: drug-sized molecules as the MM-DTI model takes them: atom
  tokens (BOS, the atoms with their hydrogens, EOS) with coordinates on a
  random walk of fixed step, and SMILES token ids (BOS, tokens, EOS),
  padded to the mix's ``atom_pad`` and ``smiles_pad``;
* ``crystals``: MOF crystals as raw element symbols and cartesian
  coordinates in a box cell, with a gas, a pressure and a temperature;
  the program featurizes them.

Every seed gets the same multiset of sizes (atoms, tokens) in another
order, so that the seed changes which rows meet and not how much work the
run does.  All draws come from numpy generators keyed by the seed and a
stream name, so one seed gives the same data on any machine.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for (seed, stream); any non-negative int seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), zlib.crc32(stream.encode())]))


def derived_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for (seed, stream), for torch generators."""
    return int(rng_for(seed, stream).integers(0, 2 ** 63 - 1))


def spread_sizes(count: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """``count`` sizes spread evenly over [lo, hi] (the same multiset for
    every seed), in an order drawn from the seed."""
    sizes = np.round(np.linspace(lo, hi, count)).astype(np.int64)
    return sizes[rng_for(seed, "size-order").permutation(count)]


def _elements(spec: Dict[str, float], vocab, n: int, rng) -> np.ndarray:
    symbols = list(spec)
    p = np.asarray([spec[s] for s in symbols], np.float64)
    picks = rng.choice(len(symbols), size=n, p=p / p.sum())
    return np.asarray([vocab.index(symbols[i]) for i in picks], np.int64)


def random_walk(n: int, step: float, rng) -> np.ndarray:
    """[n, 3] float32 points, each ``step`` from the last in a uniform
    direction, centred."""
    d = rng.normal(size=(n, 3))
    d *= step / np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = 0.0
    pts = np.cumsum(d, axis=0)
    return (pts - pts.mean(axis=0)).astype(np.float32)


def molecules(cfg: dict, mix: dict, seed: int) -> Dict[str, np.ndarray]:
    """The molecule data set, padded: src_tokens [R, N] int64, src_coord
    [R, N, 3] float32, input_ids and attention_mask [R, L] int64, labels
    [R, 1] float32, and the real sizes n_atoms (with BOS and EOS) and
    n_tokens (with BOS and EOS)."""
    ds = mix["dataset"]
    R, N, L = ds["count"], mix["atom_pad"], mix["smiles_pad"]
    vocab = cfg["atom_vocab"]
    pad, bos, eos = cfg["atom_pad_idx"], vocab.index("[CLS]"), vocab.index("[SEP]")
    sm = cfg["smiles_tokens"]
    atoms = spread_sizes(R, *ds["atoms"], seed)
    tokens = spread_sizes(R, *ds["smiles_tokens"], seed + 1)
    if atoms.max() + 2 > N or tokens.max() > L:
        raise ValueError(f"the mix's sizes do not fit its pads N={N}, L={L}")
    rng = rng_for(seed, "molecules")
    src_tokens = np.full((R, N), pad, np.int64)
    src_coord = np.zeros((R, N, 3), np.float32)
    input_ids = np.full((R, L), sm["pad"], np.int64)
    attention_mask = np.zeros((R, L), np.int64)
    for r in range(R):
        n, t = int(atoms[r]), int(tokens[r])
        src_tokens[r, 0], src_tokens[r, n + 1] = bos, eos
        src_tokens[r, 1:n + 1] = _elements(ds["elements"], vocab, n, rng)
        src_coord[r, 1:n + 1] = random_walk(n, ds["step_angstrom"], rng)
        input_ids[r, 0], input_ids[r, t - 1] = sm["bos"], sm["eos"]
        input_ids[r, 1:t - 1] = rng.integers(sm["first_plain"], cfg["chemberta"]["vocab_size"],
                                             t - 2)
        attention_mask[r, :t] = 1
    labels = rng.normal(size=(R, 1)).astype(np.float32)
    return {"src_tokens": src_tokens, "src_coord": src_coord, "input_ids": input_ids,
            "attention_mask": attention_mask, "labels": labels,
            "n_atoms": atoms + 2, "n_tokens": tokens}


def crystals(cfg: dict, mix: dict, seed: int) -> dict:
    """The crystal data set, raw: per crystal its element symbols, its
    cartesian coordinates [n, 3] float32 and the seed of its crop; and
    gas_id [R] int64, gas_attr [R, A] float32, pressure and temperature [R]
    float32, labels [R, 1] float32."""
    ds = mix["dataset"]
    R = ds["count"]
    gases = cfg["gas_env"]["gases"]
    sizes = spread_sizes(R, *ds["atoms"], seed)
    rng = rng_for(seed, "crystals")
    symbols, coords, crop_seeds = [], [], []
    names = list(ds["elements"])
    p = np.asarray([ds["elements"][s] for s in names], np.float64)
    lo, hi = ds["cell_angstrom"]
    for r in range(R):
        n = int(sizes[r])
        symbols.append([names[i] for i in rng.choice(len(names), size=n, p=p / p.sum())])
        cell = lo + rng.random(3) * (hi - lo)
        coords.append((rng.random((n, 3)) * cell).astype(np.float32))
        crop_seeds.append(int(rng.integers(0, 2 ** 31 - 1)))
    which = rng.integers(0, len(gases), R)
    gas_names = sorted(gases)
    p_lo, p_hi = np.log(ds["pressure_bar"][0]), np.log(ds["pressure_bar"][1])
    return {
        "symbols": symbols, "coords": coords, "crop_seeds": crop_seeds,
        "gas_id": np.asarray([gases[gas_names[i]]["id"] for i in which], np.int64),
        "gas_attr": np.asarray([gases[gas_names[i]]["attr"] for i in which], np.float32),
        "pressure": np.exp(rng.uniform(p_lo, p_hi, R)).astype(np.float32),
        "temperature": rng.uniform(*ds["temperature_k"], R).astype(np.float32),
        "labels": rng.normal(size=(R, 1)).astype(np.float32),
        "n_atoms": np.minimum(sizes, mix["max_atoms"]) + 2,
    }


def epoch_orders(rows: int, batch: int, epochs: int, seed: int) -> np.ndarray:
    """[epochs * (rows // batch), batch] int64 row indices: one permutation
    of the rows an epoch, cut into batches (a remainder is dropped)."""
    rng = rng_for(seed, "order")
    per = rows // batch
    return np.concatenate([rng.permutation(rows)[:per * batch].reshape(per, batch)
                           for _ in range(epochs)])
